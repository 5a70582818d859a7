"""Device-mesh distribution: shot sharding, counter psum reduction, multi-host
initialization, and RNG-layout discipline (SURVEY.md §5.8 — the reference is
single-process; these are the scaling axes from BASELINE.json)."""

from qldpcsim_jax.parallel.mesh import (
    make_mesh,
    shard_chunk_fn,
    chunk_keys,
    multihost_init,
)

__all__ = ["make_mesh", "shard_chunk_fn", "chunk_keys", "multihost_init"]
