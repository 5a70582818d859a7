"""Mesh construction and shot-sharded execution.

Parallel axes (SURVEY.md §2, "parallelism strategies"): shots are
embarrassingly parallel Monte Carlo — the batch axis shards over a 1-D
('shots',) mesh; p-points are an outer loop (optionally a
second mesh axis — see dryrun in __graft_entry__.py). The entire cross-device
reduction payload is the per-chunk integer counter vector (simulator.py:308-315
in the reference), reduced with psum inside shard_map.

RNG discipline: per-chunk keys are derived from global chunk indices
(seed -> p-index -> global chunk), so counters are bit-exact regardless of
device count — integer sums are order-independent. Tested in
tests/test_parallel.py on a virtual 8-device CPU mesh.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from qldpcsim_jax.utils.jaxcache import enable_compilation_cache

enable_compilation_cache()


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed when running under a multi-host launcher.

    MUST run before any backend query: jax.devices()/jax.process_count()
    initialize the local backend, after which jax.distributed.initialize()
    raises. Launch context comes from the explicit arguments or, when absent,
    the standard env vars JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID. With no context at all this is a no-op —
    plain single-host runs never touch the distributed service. Returns
    True iff the distributed runtime is initialized on exit.

    The reference has no distributed path at all (simulator.py is a single
    process); tested with two real processes in tests/test_multihost.py.
    """
    import os

    if jax.distributed.is_initialized():
        return True
    coordinator_address = (coordinator_address
                          or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and process_id is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def make_mesh(devices=None, axis: str = "shots") -> Mesh:
    """1-D device mesh over all (or given) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis,))


def chunk_keys(key_p, chunk_start: int, n_parallel: int):
    """Deterministic per-slot keys for global chunk indices
    chunk_start .. chunk_start + n_parallel - 1."""
    idx = jnp.arange(chunk_start, chunk_start + n_parallel, dtype=jnp.uint32)
    return jax.vmap(lambda i: jax.random.fold_in(key_p, i))(idx)


def shard_chunk_fn(mesh: Mesh, chunk_fn: Callable, axis: str = "shots"):
    """Wrap a single-device chunk body for shot-sharded execution.

    chunk_fn(key, p, n_valid) -> dict of scalar counters. The wrapped function
    takes per-device keys (ndev, ...) and per-device valid counts (ndev,),
    runs one chunk per device, and psums the counter dict over the mesh so
    every process sees the global counts.
    """
    from jax import shard_map

    def per_device(keys, p, n_valids):
        counts = chunk_fn(keys[0], p, n_valids[0])
        return {k: jax.lax.psum(v, axis) for k, v in counts.items()}

    sharded = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(axis), P(), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(sharded)


def allreduce_counters_host(counts: dict, tag: str, seq: int) -> dict:
    """Sum per-process integer counter dicts across ALL processes WITHOUT
    compiling any partitioned program.

    exec_mode='perdevice' compiles no partitioned program, so the
    cross-process reduction must not depend on one either. Primary
    path: the jax.distributed coordination service's key-value store (the
    same service that bootstrapped the processes; zero device code). Each
    process posts its JSON counter dict under a (tag, seq, process) key and
    folds in every peer's. Fallback when no KV client exists:
    multihost_utils.process_allgather (one tiny all_gather jit over a
    (n_proc, n_keys) int array — still never the decode graph).

    `seq` must be a per-call-site monotonically increasing sequence number
    (key uniqueness across calls); all processes must call with the same
    tag/seq stream — it is a synchronization point, like any collective.
    Values may be Python ints or 1-D integer arrays (per-p counter rows).
    """
    import json as _json

    nproc = jax.process_count()
    if nproc == 1:
        return counts
    keys = sorted(counts)
    as_list = {k: np.asarray(counts[k], np.int64).reshape(-1).tolist()
               for k in keys}

    from jax._src import distributed

    client = getattr(distributed.global_state, "client", None)
    if client is None:
        from jax.experimental import multihost_utils

        vec = np.concatenate([np.asarray(as_list[k], np.int64)
                              for k in keys])
        allv = np.asarray(multihost_utils.process_allgather(vec))
        tot = allv.sum(axis=0)
    else:
        me = jax.process_index()
        base = f"qldpc/{tag}/{seq}"
        blob = _json.dumps([as_list[k] for k in keys])
        client.key_value_set(f"{base}/{me}", blob)
        tot = None
        for pi in range(nproc):
            b = blob if pi == me else client.blocking_key_value_get(
                f"{base}/{pi}", 120_000)
            v = np.concatenate([np.asarray(row, np.int64)
                                for row in _json.loads(b)])
            tot = v if tot is None else tot + v

    out = {}
    o = 0
    for k in keys:
        w = len(as_list[k])
        part = tot[o:o + w]
        o += w
        out[k] = (int(part[0]) if np.ndim(counts[k]) == 0
                  else np.asarray(part, np.int64))
    return out


def local_mesh_rows(mesh: Mesh):
    """(global_index, device) pairs of THIS process's devices in the mesh's
    flat order — the rows of a (ndev, ...)-laid-out input this process may
    address."""
    me = jax.process_index()
    return [(i, d)
            for i, d in enumerate(np.asarray(mesh.devices).reshape(-1))
            if d.process_index == me]


def per_device_multi_chunk_fn(mesh: Mesh, multi_fn: Callable):
    """Per-device dispatch for shot-sharded execution (exec_mode='perdevice').

    Same call signature as shard_multi_chunk_fn's wrapper — keys
    (ndev, G, tiles, 2), p scalar, n_valids (ndev, G) — but instead of one
    shard_map program it dispatches the SINGLE-DEVICE multi-chunk jit once
    per mesh device (dispatches are async, so devices run concurrently) and
    reduces the integer counters on the host. The global RNG tile contract
    (keys derive from global tile indices, not device ids) makes the totals
    bit-exact vs the shard_map path by construction.

    Multi-PROCESS meshes: each process dispatches to its LOCAL mesh devices
    (every process derives the identical global key/n_valid layout from the
    shared seed, so row i of the inputs is device i's work wherever it
    lives), then the 9-integer counter vector is summed across processes via
    allreduce_counters_host — the coordination-service KV store, never a
    partitioned compile. The decode itself never needs shard_map.
    """
    local = local_mesh_rows(mesh)
    fn = jax.jit(multi_fn)
    seq = iter(range(1 << 62))

    def run(keys, p, n_valids):
        keys = np.asarray(jax.device_get(keys))
        n_valids = np.asarray(jax.device_get(n_valids))
        p32 = jnp.float32(p)
        outs = [fn(jax.device_put(keys[i], d), jax.device_put(p32, d),
                   jax.device_put(n_valids[i], d))
                for i, d in local]
        outs = jax.device_get(outs)
        counts = {k: sum(int(o[k]) for o in outs) for k in outs[0]}
        return allreduce_counters_host(counts, "pdmc", next(seq))

    return run


def shard_multi_chunk_fn(mesh: Mesh, multi_fn: Callable, axis: str = "shots"):
    """Shot-sharded wrapper for the fused multi-chunk body.

    multi_fn(keys, p, n_valids) scans G chunks on one device and returns
    summed counters. The wrapped function takes keys (ndev, G, tiles, 2) and
    n_valids (ndev, G); each device runs its G-chunk scan, then the counter
    dict is psum-reduced over the mesh — one collective per G chunks instead
    of one per chunk."""
    from jax import shard_map

    def per_device(keys, p, n_valids):
        counts = multi_fn(keys[0], p, n_valids[0])
        return {k: jax.lax.psum(v, axis) for k, v in counts.items()}

    sharded = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(axis), P(), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(sharded)
