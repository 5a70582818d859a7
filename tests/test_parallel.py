"""Distributed-path tests on a virtual 8-device CPU mesh (SURVEY.md §4.4):
sharded counters must be BIT-EXACT vs single-device (integer psum)."""

import jax
import numpy as np
import pytest

from qldpcsim_jax.codes import get_code
from qldpcsim_jax.engine.montecarlo import ShotPipeline, SimConfig, simulate_p
from qldpcsim_jax.parallel import make_mesh


pytestmark = pytest.mark.usefixtures("eight_devices")


def test_sharded_counters_bit_exact():
    code = get_code("steane")
    base = dict(shots=1024, dec_type="MS", dec_iterations=15, rng_seed=17)
    # batch % (64 * ndev) == 0 => identical global RNG tile stream in both
    # layouts (tile=64), so counters must match bit-exactly.
    r_single = simulate_p(code.Hx, code.Hz, 0.03,
                          SimConfig(batch_size=512, **base))
    mesh = make_mesh()
    r_sharded = simulate_p(code.Hx, code.Hz, 0.03,
                           SimConfig(batch_size=512, mesh=mesh, **base))
    assert r_sharded.counters == r_single.counters
    assert r_sharded.avg_iterations_x == r_single.avg_iterations_x
    assert r_sharded.avg_iterations_z == r_single.avg_iterations_z


def test_sharded_partial_chunk():
    code = get_code("shor")
    base = dict(shots=200, dec_type="MS", dec_iterations=10, rng_seed=23)
    mesh = make_mesh()
    r = simulate_p(code.Hx, code.Hz, 0.02, SimConfig(batch_size=80, mesh=mesh, **base))
    assert sum(1 for _ in r.counters) == 7
    assert r.counters["decSuccessExact"] <= 200
    # Shots conservation: successes + qBLER complement consistent.
    assert r.shots == 200


def test_sharded_osd_bit_exact():
    """Mesh + deferred group-level OSD (shard_map per-device compaction)
    must reproduce the single-device counters exactly."""
    code = get_code("lp04_0")
    base = dict(shots=512, dec_type="BP", dec_iterations=8, rng_seed=5,
                osd_order=1)
    r_single = simulate_p(code.Hx, code.Hz, 0.05,
                          SimConfig(batch_size=512, **base))
    mesh = make_mesh()
    r_sharded = simulate_p(code.Hx, code.Hz, 0.05,
                           SimConfig(batch_size=512, mesh=mesh, **base))
    assert r_sharded.counters == r_single.counters


def test_mesh_device_count_invariance_bit_exact():
    """Counters are BIT-EXACT across 1, 2, 4 and 8 participating devices
    when the batch respects the layout quantum (batch % (64 * ndev) == 0
    for every count => tile=64 and an identical GLOBAL RNG tile stream in
    every layout; integer counter psum is order-independent)."""
    code = get_code("steane")
    base = dict(shots=1536, dec_type="BP", dec_iterations=12, rng_seed=31)
    results = []
    for ndev in (1, 2, 4, 8):
        mesh = make_mesh(jax.devices()[:ndev])
        r = simulate_p(code.Hx, code.Hz, 0.02,
                       SimConfig(batch_size=512, mesh=mesh, **base))
        results.append((ndev, r))
    (_, r1), *rest = results
    for ndev, r in rest:
        assert r.counters == r1.counters, ndev
        assert r.avg_iterations_x == r1.avg_iterations_x, ndev
        assert r.avg_iterations_z == r1.avg_iterations_z, ndev
    # run-to-run determinism for a fixed layout
    r2 = simulate_p(code.Hx, code.Hz, 0.02,
                    SimConfig(batch_size=512, mesh=make_mesh(), **base))
    assert r2.counters == r1.counters


def test_perdevice_exec_mode_bit_exact():
    """exec_mode='perdevice' (one single-device dispatch per mesh device,
    host-side reduction) must equal the shard_map counters AND the
    single-device counters bit-exactly, including with OSD in the loop."""
    code = get_code("lp04_0")
    base = dict(shots=512, dec_type="BP", dec_iterations=8, rng_seed=5,
                osd_order=1)
    r_single = simulate_p(code.Hx, code.Hz, 0.05,
                          SimConfig(batch_size=512, **base))
    mesh = make_mesh()
    r_shard = simulate_p(code.Hx, code.Hz, 0.05,
                         SimConfig(batch_size=512, mesh=mesh,
                                   exec_mode="shardmap", **base))
    r_perdev = simulate_p(code.Hx, code.Hz, 0.05,
                          SimConfig(batch_size=512, mesh=mesh,
                                    exec_mode="perdevice", **base))
    assert r_perdev.counters == r_shard.counters == r_single.counters
    assert r_perdev.avg_iterations_x == r_single.avg_iterations_x


def test_perdevice_partial_chunk():
    """Per-device mode with a ragged final chunk (shots not a multiple of
    batch) counts exactly like the serial path."""
    code = get_code("steane")
    base = dict(shots=1000, dec_type="MS", dec_iterations=10, rng_seed=23)
    r_single = simulate_p(code.Hx, code.Hz, 0.03,
                          SimConfig(batch_size=512, **base))
    r = simulate_p(code.Hx, code.Hz, 0.03,
                   SimConfig(batch_size=512, mesh=make_mesh(),
                             exec_mode="perdevice", **base))
    assert r.counters == r_single.counters


def test_perdevice_sweep_bit_exact():
    """simulate_sweep under exec_mode='perdevice' (per (p-row, device)
    dispatch on the 2-D grid) reproduces the serial per-p counters."""
    from qldpcsim_jax.engine.montecarlo import simulate_sweep

    code = get_code("steane")
    ps = [0.01, 0.03, 0.05, 0.07]
    base = dict(shots=512, dec_type="MS", dec_iterations=10, rng_seed=9,
                batch_size=256)
    serial = [simulate_p(code.Hx, code.Hz, pT, SimConfig(**base), p_index=i)
              for i, pT in enumerate(ps)]
    swept = simulate_sweep(code.Hx, code.Hz, ps,
                           SimConfig(mesh_p=2, exec_mode="perdevice", **base))
    swept_sm = simulate_sweep(code.Hx, code.Hz, ps,
                              SimConfig(mesh_p=2, exec_mode="shardmap",
                                        **base))
    for rs, rp, rm in zip(serial, swept, swept_sm):
        assert rp.counters == rs.counters == rm.counters
        assert rp.avg_iterations_x == rs.avg_iterations_x


def test_shardmap_failure_raises(monkeypatch):
    """A shard_map failure surfaces to the caller: no silent switch to
    per-device dispatch hides which execution path ran."""
    from qldpcsim_jax.parallel import mesh as mesh_mod

    def broken(mesh, fn, axis="shots"):
        def run(*a):
            raise RuntimeError("partitioner exploded")
        return run

    monkeypatch.setattr(mesh_mod, "shard_multi_chunk_fn", broken)
    code = get_code("steane")
    cfg = SimConfig(shots=512, dec_type="MS", dec_iterations=5, rng_seed=1,
                    batch_size=512, mesh=make_mesh())
    with pytest.raises(RuntimeError, match="partitioner exploded"):
        simulate_p(code.Hx, code.Hz, 0.03, cfg)
