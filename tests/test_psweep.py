"""p-point parallelism tests: the ('p','shots') 2-D mesh sweep
(engine/montecarlo.simulate_sweep) must reproduce the serial p-loop
bit-exactly — same per-p key hierarchy (seed -> p-index -> global tile) and
per-row chunk layout (SURVEY.md §2: the reference p-loop simulator.py:335-339
as a parallel axis)."""

import jax
import numpy as np
import pytest

from qldpcsim_jax.codes import get_code
from qldpcsim_jax.engine.montecarlo import (SimConfig, simulate_p,
                                            simulate_sweep)

pytestmark = pytest.mark.usefixtures("eight_devices")


def _serial(code, ps, cfg):
    return [simulate_p(code.Hx, code.Hz, pT,
                       SimConfig(**{**cfg.__dict__, "mesh_p": 0}), p_index=i)
            for i, pT in enumerate(ps)]


@pytest.mark.parametrize("dec,osd", [("MS", -1), ("BP", 1)])
def test_psweep_bit_exact_vs_serial(dec, osd):
    code = get_code("lp04_0")
    ps = [0.02, 0.04, 0.06]  # 3 p-points over 2 p-rows: exercises padding
    cfg = SimConfig(shots=1280, dec_type=dec, dec_iterations=8, rng_seed=7,
                    osd_order=osd, batch_size=512, mesh_p=2)
    swept = simulate_sweep(code.Hx, code.Hz, ps, cfg)
    serial = _serial(code, ps, cfg)
    assert len(swept) == len(serial) == 3
    for rs, rr in zip(swept, serial):
        assert rs.p == rr.p
        assert rs.counters == rr.counters, rs.p
        assert rs.avg_iterations_x == rr.avg_iterations_x
        assert rs.avg_iterations_z == rr.avg_iterations_z


def test_psweep_checkpoint_resume(tmp_path):
    """A sweep interrupted mid-block resumes from the last completed group
    and produces identical counters (same group layout + deterministic per-p
    tile streams)."""
    code = get_code("steane")
    base = dict(shots=768, dec_iterations=10, rng_seed=9, batch_size=256,
                mesh_p=2, dispatch_chunks=1)
    full = simulate_sweep(code.Hx, code.Hz, [0.02, 0.04],
                          SimConfig(checkpoint_dir=str(tmp_path / "a"), **base))
    # simulate preemption: run one group only, then resume in a fresh call
    ckdir = tmp_path / "b"
    import qldpcsim_jax.utils.checkpoint as ck

    orig_save = ck.CheckpointStore.save
    calls = {"n": 0}

    class Stop(Exception):
        pass

    def save_once(self, run_id, counters, chunks_done):
        orig_save(self, run_id, counters, chunks_done)
        calls["n"] += 1
        if calls["n"] == 1:
            raise Stop

    ck.CheckpointStore.save = save_once
    try:
        with pytest.raises(Stop):
            simulate_sweep(code.Hx, code.Hz, [0.02, 0.04],
                           SimConfig(checkpoint_dir=str(ckdir), **base))
    finally:
        ck.CheckpointStore.save = orig_save
    resumed = simulate_sweep(code.Hx, code.Hz, [0.02, 0.04],
                             SimConfig(checkpoint_dir=str(ckdir), **base))
    for rf, rr in zip(full, resumed):
        assert rf.counters == rr.counters


def test_psweep_cli(tmp_path, capsys):
    """--mesh-p end-to-end through the CLI (the production surface)."""
    import json

    from qldpcsim_jax.cli import main

    code = get_code("steane")
    hx, hz = tmp_path / "hx.npy", tmp_path / "hz.npy"
    np.save(hx, np.asarray(code.Hx))
    np.save(hz, np.asarray(code.Hz))
    out = tmp_path / "res.jsonl"
    rc = main(["--Hx", str(hx), "--Hz", str(hz), "--p", "0.01", "0.03",
               "--shots", "512", "--decType", "MS", "--decIterations", "10",
               "--rngSeed", "5", "--batch", "512", "--mesh-p", "2",
               "--quiet", "--out", str(out)])
    assert rc == 0
    rows = [json.loads(l) for l in out.read_text().splitlines()]
    assert [r["p"] for r in rows] == [0.01, 0.03]
    ref = _serial(code, [0.01, 0.03],
                  SimConfig(shots=512, dec_iterations=10, rng_seed=5,
                            batch_size=512))
    for row, rr in zip(rows, ref):
        for k, v in rr.counters.items():
            assert row[k] == v, (row["p"], k)


def test_sweep_per_p_timing():
    """Sweep results carry meaningful per-p timing (round-3 verdict #7):
    per-point wall_time_s sums to the block totals, and with >= 2 dispatch
    groups every point reports a finite warm rate; the JSON rows expose
    shots_per_s_warm (None only when cold)."""
    import json

    code = get_code("steane")
    cfg = SimConfig(shots=512, dec_type="MS", dec_iterations=8, rng_seed=3,
                    batch_size=128, mesh_p=2, dispatch_chunks=1)
    rs = simulate_sweep(code.Hx, code.Hz, [0.01, 0.02, 0.03, 0.04], cfg)
    assert len(rs) == 4
    for r in rs:
        assert r.wall_time_s > 0
        # 4 chunks, 1 chunk per dispatch -> 3 warm dispatches of 128 shots
        assert r.warm_shots == 384
        assert r.warm_time_s == r.warm_time_s  # finite
        assert r.shots_per_s_warm > 0
        row = json.loads(r.to_json())
        assert row["shots_per_s_warm"] > 0
    # within one block both points share the dispatches: equal split
    assert rs[0].wall_time_s == rs[1].wall_time_s


def test_sweep_group_cascade_and_overflow_retry(monkeypatch):
    """simulate_sweep under the opt-in group cascade: normal-p blocks match
    the default path bit-exactly, and a very-high-p block (deferral
    overflow on every chunk) triggers the group retry through the
    non-deferring step — still bit-exact."""
    code = get_code("lp04_0")
    ps = [0.03, 0.30]  # second point overflows the deferral cap
    base = dict(shots=1024, dec_type="MS", dec_iterations=16, rng_seed=5,
                batch_size=512, mesh_p=2)
    monkeypatch.setenv("QLDPC_GROUP_CASCADE", "1")
    swept_gc = simulate_sweep(code.Hx, code.Hz, ps, SimConfig(**base))
    monkeypatch.delenv("QLDPC_GROUP_CASCADE")
    swept = simulate_sweep(code.Hx, code.Hz, ps, SimConfig(**base))
    for a, b in zip(swept_gc, swept):
        assert a.counters == b.counters, a.p
        assert a.avg_iterations_x == b.avg_iterations_x, a.p
