"""Multi-host (multi-process) initialization and distributed-engine test.

SURVEY.md §4.4 / §5.8: the reference is single-process (simulator.py), so
multi-host behavior is a north-star requirement — jax.distributed +
psum-reduced counters. This test spawns TWO real OS processes with a local
coordinator (1 CPU device each), runs the full engine over the global
2-device mesh in each, and asserts the psum-reduced counters are bit-exact
with a single-process run of the same configuration: the RNG tile stream is
keyed by global tile index, so counters are layout-invariant by design
(parallel/mesh.py "RNG discipline").
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

from qldpcsim_jax.codes import get_code
from qldpcsim_jax.engine.montecarlo import SimConfig, simulate_p

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SHOTS, _BATCH, _P, _SEED, _ITERS = 256, 128, 0.03, 3, 10

_CHILD = textwrap.dedent("""
    import os, json, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, %r)
    from qldpcsim_jax.parallel.mesh import multihost_init, make_mesh

    # env-var detection path (JAX_COORDINATOR_ADDRESS / _NUM_PROCESSES /
    # _PROCESS_ID set by the parent); must run before any backend query.
    assert multihost_init(), "multihost_init found no launch context"
    assert multihost_init(), "second call must be an idempotent no-op"
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 2, jax.devices()

    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.engine.montecarlo import SimConfig, simulate_p

    code = get_code("steane")
    cfg = SimConfig(shots=%d, dec_type="MS", dec_iterations=%d, rng_seed=%d,
                    batch_size=%d, mesh=make_mesh(), device="auto")
    r = simulate_p(code.Hx, code.Hz, %r, cfg)

    # p-sweep over the ('p','shots') mesh ACROSS the two processes: each
    # process owns one p-row; per-p counters must come back global.
    from qldpcsim_jax.engine.montecarlo import simulate_sweep
    cfg2 = SimConfig(shots=%d, dec_type="MS", dec_iterations=%d, rng_seed=%d,
                     batch_size=%d, mesh_p=2, device="auto")
    sweep = simulate_sweep(code.Hx, code.Hz, [%r, 0.06], cfg2)

    # exec_mode='perdevice' on the SAME multi-process mesh: each process
    # dispatches plain single-device jits to its local device and the
    # counter vector reduces through the coordination-service KV store —
    # no shard_map / partitioned compile anywhere (the r4 verdict's
    # missing fallback for multi-HOST pods on backends whose partitioner
    # hangs). Counters must be bit-exact by the RNG tile contract.
    cfg_pd = SimConfig(shots=%d, dec_type="MS", dec_iterations=%d,
                       rng_seed=%d, batch_size=%d, mesh=make_mesh(),
                       device="auto", exec_mode="perdevice")
    r_pd = simulate_p(code.Hx, code.Hz, %r, cfg_pd)
    cfg_pds = SimConfig(shots=%d, dec_type="MS", dec_iterations=%d,
                        rng_seed=%d, batch_size=%d, mesh_p=2,
                        device="auto", exec_mode="perdevice")
    sweep_pd = simulate_sweep(code.Hx, code.Hz, [%r, 0.06], cfg_pds)
    with open(os.environ["QLDPC_MH_OUT"] + str(jax.process_index()), "w") as f:
        json.dump({"single": r.counters,
                   "sweep": [s.counters for s in sweep],
                   "single_pd": r_pd.counters,
                   "sweep_pd": [s.counters for s in sweep_pd]}, f)
""" % (_REPO, _SHOTS, _ITERS, _SEED, _BATCH, _P,
       _SHOTS, _ITERS, _SEED, _BATCH, _P,
       _SHOTS, _ITERS, _SEED, _BATCH, _P,
       _SHOTS, _ITERS, _SEED, _BATCH, _P))


def test_two_process_counters_match_single_process(tmp_path):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()

    out_prefix = str(tmp_path / "counters")
    procs = []
    for i in range(2):
        env = dict(os.environ)
        env.update(
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(i),
            QLDPC_MH_OUT=out_prefix,
        )
        # The parent's virtual-8-device flag would give each child 8 local
        # devices; the test wants 1 per process (the SURVEY §4.4 shape).
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen([sys.executable, "-c", _CHILD], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        # communicate() drains the pipes while waiting (wait() with piped
        # stderr can deadlock on a chatty child)
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    rcs = [p.returncode for p in procs]
    assert rcs == [0, 0], [o[1][-3000:] for o in outs]

    # Both processes must see the GLOBAL (psum-reduced) counters.
    c0 = json.load(open(out_prefix + "0"))
    c1 = json.load(open(out_prefix + "1"))
    assert c0 == c1

    # Bit-exact against single-process runs of the same configuration
    # (integer counter psum + layout-invariant RNG tile stream).
    code = get_code("steane")
    cfg = SimConfig(shots=_SHOTS, dec_type="MS", dec_iterations=_ITERS,
                    rng_seed=_SEED, batch_size=_BATCH)
    ref = simulate_p(code.Hx, code.Hz, _P, cfg)
    assert c0["single"] == ref.counters

    # cross-process p-sweep mesh: per-p rows match serial per-p runs
    refs = [simulate_p(code.Hx, code.Hz, pT, cfg, p_index=i)
            for i, pT in enumerate([_P, 0.06])]
    assert c0["sweep"] == [r.counters for r in refs]

    # multi-process exec_mode='perdevice' (shard_map-free): bit-exact too
    assert c0["single_pd"] == ref.counters
    assert c0["sweep_pd"] == [r.counters for r in refs]


def test_multihost_init_noop_without_context(monkeypatch):
    """No launch context -> no-op False, and the local backend is untouched
    (the r2 bug: jax.process_count() before initialize() poisoned the init
    path and a blanket except hid it)."""
    from qldpcsim_jax.parallel import mesh

    for v in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    assert mesh.multihost_init() is False
