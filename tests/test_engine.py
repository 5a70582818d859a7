"""End-to-end engine tests: channel statistics, counter semantics,
reproducibility, checkpoint/resume, and CLI (SURVEY.md §4.3)."""

import json

import numpy as np
import pytest

from qldpcsim_jax.codes import get_code
from qldpcsim_jax.engine.montecarlo import ShotPipeline, SimConfig, simulate_p
from qldpcsim_jax.engine.results import format_results_table


def _run(codename, **kw):
    code = get_code(codename)
    defaults = dict(shots=512, dec_type="MS", dec_iterations=20,
                    dec_schedule="F", rng_seed=3, batch_size=256)
    defaults.update(kw)
    cfg = SimConfig(**defaults)
    return simulate_p(code.Hx, code.Hz, kw.pop("p", 0.02), cfg)


def test_counters_sum_consistency():
    code = get_code("steane")
    cfg = SimConfig(shots=400, dec_iterations=25, rng_seed=5, batch_size=128)
    r = simulate_p(code.Hx, code.Hz, 0.03, cfg)
    c = r.counters
    # Exact successes are a subset of honest successes.
    assert c["decSuccessExact"] <= c["successStabilizer"]
    # Everything bounded by shots.
    for v in c.values():
        assert 0 <= v <= 400
    # qBLER definitions.
    assert r.qbler == 1.0 - (c["decSuccessExact"] + c["decSuccessDegen"]) / 400
    assert r.qbler_honest <= r.qbler + 1e-12


def test_low_p_mostly_success():
    code = get_code("steane")
    cfg = SimConfig(shots=512, dec_iterations=30, rng_seed=7, batch_size=256)
    r = simulate_p(code.Hx, code.Hz, 0.005, cfg)
    # At p=0.5% on Steane nearly all shots decode exactly.
    assert r.counters["decSuccessExact"] > 450
    assert r.avg_iterations_x < 3
    assert r.counters["DecFailures_X"] + r.counters["DecFailures_Z"] < 20


def test_reproducibility_and_batch_invariance():
    code = get_code("shor")
    base = dict(shots=300, dec_iterations=15, rng_seed=11)
    r1 = simulate_p(code.Hx, code.Hz, 0.04, SimConfig(batch_size=100, **base))
    r2 = simulate_p(code.Hx, code.Hz, 0.04, SimConfig(batch_size=100, **base))
    assert r1.counters == r2.counters
    assert r1.avg_iterations_x == r2.avg_iterations_x


def test_fused_dispatch_counter_parity():
    """G-chunk fused dispatch (lax.scan) totals == per-chunk totals, and
    simulate_p is invariant to the dispatch grouping."""
    import jax
    import jax.numpy as jnp

    from qldpcsim_jax.parallel.mesh import chunk_keys

    code = get_code("steane")
    cfg = SimConfig(shots=512, dec_iterations=20, rng_seed=11, batch_size=128)
    pipe = ShotPipeline(code.Hx, code.Hz, cfg)
    key = jax.random.fold_in(jax.random.PRNGKey(11), 0)
    tpc = pipe.tiles_per_chunk
    G = 4
    keys = chunk_keys(key, 0, G * tpc)
    fused = jax.device_get(pipe._multi_counts(
        keys.reshape(G, tpc, -1), jnp.float32(0.03),
        jnp.full((G,), 128, jnp.int32)))
    per = {}
    for c in range(G):
        o = jax.device_get(pipe._chunk_counts(
            chunk_keys(key, c * tpc, tpc), jnp.float32(0.03), jnp.int32(128)))
        for k, v in o.items():
            per[k] = per.get(k, 0) + int(v)
    # the fused body additionally reports the cascade-deferral overflow flag
    assert int(fused.get("gcOverflow", 0)) == 0
    assert {k: int(v) for k, v in fused.items() if k != "gcOverflow"} == per

    # simulate_p grouping invariance (dispatch_chunks 1 vs 4 vs padded 3).
    rs = [simulate_p(code.Hx, code.Hz, 0.03,
                     SimConfig(shots=512, dec_iterations=20, rng_seed=11,
                               batch_size=128, dispatch_chunks=g))
          for g in (1, 3, 4)]
    assert rs[0].counters == rs[1].counters == rs[2].counters
    assert rs[0].avg_iterations_x == rs[1].avg_iterations_x


def test_partial_final_chunk_counts_exactly():
    code = get_code("steane")
    cfg = SimConfig(shots=333, dec_iterations=10, rng_seed=2, batch_size=128)
    r = simulate_p(code.Hx, code.Hz, 0.02, cfg)
    c = r.counters
    # exact + non-exact classes can't exceed shots; failures bounded.
    assert c["decSuccessExact"] <= 333
    assert c["DecFailures_X"] <= 333
    total_classified = c["successStabilizer"] + c["logicalErrors_X"]
    assert total_classified <= 333 + c["logicalErrors_X"]  # sanity


def test_osd_path_runs_and_helps():
    code = get_code("lp04_0")
    base = dict(shots=256, dec_iterations=4, rng_seed=9, batch_size=128)
    r_plain = simulate_p(code.Hx, code.Hz, 0.05,
                         SimConfig(dec_type="MS", **base))
    r_osd = simulate_p(code.Hx, code.Hz, 0.05,
                       SimConfig(dec_type="MS", osd_order=1, **base))
    # OSD resolves syndrome mismatches of failed shots.
    assert r_osd.counters["DecFailures_X"] <= r_plain.counters["DecFailures_X"]
    assert r_osd.counters["DecFailures_Z"] <= r_plain.counters["DecFailures_Z"]
    assert r_osd.counters["DecFailures_X"] == 0  # OSD always matches syndrome


def test_osd_fused_matches_host_compaction():
    """The fused in-body OSD path (on-device argsort compaction + windowed
    while_loop) produces counters bit-exact with an independent host-side
    application of the same OSD function to exactly the decoder-failed valid
    shots (the semantics of the reference's failure-gated OSD,
    decoders.py:179-180)."""
    import jax
    import jax.numpy as jnp

    from qldpcsim_jax.parallel.mesh import chunk_keys

    code = get_code("lp04_0")
    shots, batch, p, seed = 320, 128, 0.06, 13
    cfg = SimConfig(shots=shots, dec_type="MS", dec_iterations=6,
                    dec_schedule="F", osd_order=1, rng_seed=seed,
                    batch_size=batch)
    r = simulate_p(code.Hx, code.Hz, p, cfg)

    pipe = ShotPipeline(code.Hx, code.Hz, cfg)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    tpc = pipe.tiles_per_chunk
    n_chunks = -(-shots // batch)
    totals = None
    p32 = jnp.float32(p)
    for c in range(n_chunks):
        keys = chunk_keys(key, c * tpc, tpc)
        err_x, err_z, sy_z, sy_x = pipe._sample(
            keys, p32, pipe.n, pipe.tile, pipe.Hx_T, pipe.Hz_T)
        res_x = pipe.dec_x(sy_z, p32 / 3.0)
        res_z = pipe.dec_z(sy_x, p32 / 3.0)
        n_valid = min(batch, shots - c * batch)
        lane_valid = np.arange(batch) < n_valid
        e_hats = []
        for res, syn, osd in ((res_x, sy_z, pipe.osd_x),
                              (res_z, sy_x, pipe.osd_z)):
            e = np.asarray(res.e_hat).copy()
            failed = np.nonzero(~np.asarray(res.converged) & lane_valid)[0]
            if failed.size:
                e_new = osd(res.e_hat[failed], syn[failed],
                            res.posterior[failed])
                e[failed] = np.asarray(e_new)
            e_hats.append(jnp.asarray(e))
        counts = jax.device_get(pipe._count(
            err_x, err_z, e_hats[0], e_hats[1], sy_z, sy_x,
            res_x.n_iter, res_z.n_iter, jnp.asarray(lane_valid)))
        counts = {k: int(v) for k, v in counts.items()}
        totals = counts if totals is None else {
            k: totals[k] + counts[k] for k in counts}

    for k, v in r.counters.items():
        assert totals[k] == v, (k, totals[k], v)
    assert totals["nIterAccX"] == round(r.avg_iterations_x * shots)


def test_osd_defer_overflow_path():
    """At very high p the union failure count exceeds the per-chunk deferral
    capacity F, exercising the in-chunk overflow OSD windows alongside the
    group-level pass. Counters must still match the independent host-side
    per-failed-shot OSD application exactly."""
    import jax
    import jax.numpy as jnp

    from qldpcsim_jax.parallel.mesh import chunk_keys

    code = get_code("lp04_0")
    shots, batch, p, seed = 512, 512, 0.22, 3
    cfg = SimConfig(shots=shots, dec_type="MS", dec_iterations=4,
                    dec_schedule="F", osd_order=0, rng_seed=seed,
                    batch_size=batch)
    pipe = ShotPipeline(code.Hx, code.Hz, cfg)
    assert pipe._defer_cap == 256  # F < batch: overflow is possible

    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    p32 = jnp.float32(p)
    keys = chunk_keys(key, 0, pipe.tiles_per_chunk)
    err_x, err_z, sy_z, sy_x = pipe._sample(
        keys, p32, pipe.n, pipe.tile, pipe.Hx_T, pipe.Hz_T)
    res_x = pipe.dec_x(sy_z, p32 / 3.0)
    res_z = pipe.dec_z(sy_x, p32 / 3.0)
    n_union = int(np.sum(~(np.asarray(res_x.converged)
                           & np.asarray(res_z.converged))))
    assert n_union > 256, f"p too low to overflow (union failures {n_union})"

    r = simulate_p(code.Hx, code.Hz, p, cfg)
    expected = None
    e_hats = []
    for res, syn, osd in ((res_x, sy_z, pipe.osd_x), (res_z, sy_x, pipe.osd_z)):
        e = np.asarray(res.e_hat).copy()
        failed = np.nonzero(~np.asarray(res.converged))[0]
        e_new = osd(res.e_hat[failed], syn[failed], res.posterior[failed])
        e[failed] = np.asarray(e_new)
        e_hats.append(jnp.asarray(e))
    counts = jax.device_get(pipe._count(
        err_x, err_z, e_hats[0], e_hats[1], sy_z, sy_x,
        res_x.n_iter, res_z.n_iter,
        jnp.ones(batch, bool)))
    expected = {k: int(v) for k, v in counts.items()}
    for k, v in r.counters.items():
        assert expected[k] == v, (k, expected[k], v)


@pytest.mark.parametrize("codename,dec,osd", [("steane", "MS", -1),
                                              ("lp04_0", "BP", 1)])
def test_validate_encoding_counters_equal_frame_free(codename, dec, osd):
    """Full encode->corrupt->extract->decode->verify pipeline
    (SimConfig.validate_encoding): a random GF(2) codeword frame is encoded
    per shot, the channel error XORed into it, syndromes extracted from the
    corrupted codeword. Frames are annihilated by both check matrices, so
    every counter must equal the frame-free channel's BIT-EXACTLY — this is
    the engine-level frame-invariance proof (reference encode pipeline:
    simulator.py:78-160)."""
    code = get_code(codename)
    base = dict(shots=384, dec_type=dec, dec_iterations=8, rng_seed=19,
                osd_order=osd, batch_size=128)
    r_plain = simulate_p(code.Hx, code.Hz, 0.04, SimConfig(**base))
    r_enc = simulate_p(code.Hx, code.Hz, 0.04,
                       SimConfig(validate_encoding=True, **base))
    assert r_enc.counters == r_plain.counters
    assert r_enc.avg_iterations_x == r_plain.avg_iterations_x
    assert r_enc.avg_iterations_z == r_plain.avg_iterations_z


def test_bp_and_bf_and_ng_paths():
    code = get_code("steane")
    for dec in ("BP", "BF", "NG"):
        cfg = SimConfig(shots=128, dec_type=dec, dec_iterations=12,
                        rng_seed=1, batch_size=128)
        r = simulate_p(code.Hx, code.Hz, 0.02, cfg)
        assert r.shots == 128
        assert r.counters["decSuccessExact"] > 60


def test_checkpoint_resume(tmp_path):
    code = get_code("steane")
    base = dict(shots=256, dec_iterations=10, rng_seed=21, batch_size=64)
    full = simulate_p(code.Hx, code.Hz, 0.03,
                      SimConfig(checkpoint_dir=str(tmp_path / "a"), **base))
    # Simulate a preempted run: pre-seed a checkpoint halfway, then resume.
    from qldpcsim_jax.utils.checkpoint import CheckpointStore

    store = CheckpointStore(str(tmp_path / "b"))  # noqa: F841 (dir creation)
    partial = simulate_p(code.Hx, code.Hz, 0.03,
                         SimConfig(checkpoint_dir=str(tmp_path / "b"), **base))
    files = sorted((tmp_path / "b").glob("*.json"))
    assert len(files) == 1
    saved = json.loads(files[0].read_text())
    assert saved["chunks_done"] == 4  # 256/64 chunks
    resumed = simulate_p(code.Hx, code.Hz, 0.03,
                         SimConfig(checkpoint_dir=str(tmp_path / "b"), **base))
    assert resumed.counters == full.counters == partial.counters


def test_results_table_and_json():
    code = get_code("steane")
    cfg = SimConfig(shots=64, dec_iterations=8, rng_seed=1, batch_size=64)
    r = simulate_p(code.Hx, code.Hz, 0.02, cfg)
    table = format_results_table([r])
    assert "SIMULATION RESULTS" in table
    assert "qBlock error rate" in table
    d = json.loads(r.to_json())
    assert d["shots"] == 64 and "qBLER" in d


def test_cli_end_to_end(tmp_path, capsys):
    from qldpcsim_jax.cli import main

    out = tmp_path / "res.jsonl"
    rc = main(["--code", "steane", "--p", "0.01", "0.03", "--shots", "64",
               "--decType", "MS", "--decIterations", "10", "--decSchedule", "L",
               "--rngSeed", "4", "--batch", "64", "--quiet",
               "--out", str(out)])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "SIMULATION RESULTS" in captured
    lines = out.read_text().strip().splitlines()
    assert len(lines) == 2
    assert json.loads(lines[0])["p"] == 0.01


def test_cli_file_inputs(tmp_path, capsys):
    from qldpcsim_jax.cli import main

    code = get_code("shor")
    hx, hz = tmp_path / "hx.npy", tmp_path / "hz.npy"
    np.save(hx, np.asarray(code.Hx))
    np.save(hz, np.asarray(code.Hz))
    rc = main(["--Hx", str(hx), "--Hz", str(hz), "--p", "0.02",
               "--shots", "32", "--quiet", "--rngSeed", "1"])
    assert rc == 0


def test_layer_compat_cross_wiring():
    """layer_compat=True reproduces the reference's cross-wired layer
    derivation (landmine L1): X-decode layers derive from Hx though the
    decode matrix is Hz. For shape-matched codes both wirings give identical
    structure; for Shor they differ and rows beyond the decode matrix are
    clipped instead of crashing."""
    import numpy as np
    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.decoders import build_layers
    from qldpcsim_jax.engine.montecarlo import ShotPipeline, SimConfig, simulate_p

    code = get_code("shor")
    # Cross-wired: decoding Hz (6 rows) with layers from Hx (2 rows).
    cross = build_layers(np.asarray(code.Hz), "L",
                         H_layerize=np.asarray(code.Hx))
    straight = build_layers(np.asarray(code.Hz), "L")
    assert cross.rows.shape != straight.rows.shape or \
        (cross.rows != straight.rows).any()
    # Engine runs end-to-end under compat mode.
    cfg = SimConfig(shots=128, dec_type="MS", dec_iterations=6,
                    dec_schedule="L", batch_size=128, rng_seed=1,
                    layer_compat=True)
    r = simulate_p(code.Hx, code.Hz, 0.02, cfg)
    assert 0.0 <= r.qbler <= 1.0


def test_compact_indices_matches_stable_argsort():
    """The cumsum-scatter compaction equals a stable argsort prefix for any
    mask, including empty, full, and overflow-past-cap cases."""
    import jax.numpy as jnp

    from qldpcsim_jax.engine.montecarlo import _compact_indices

    rng = np.random.default_rng(5)
    for B, cap in ((64, 16), (64, 64), (128, 32)):
        for frac in (0.0, 0.1, 0.9, 1.0):
            mask = rng.random(B) < frac
            got = np.asarray(_compact_indices(jnp.asarray(mask), cap, fill=B))
            want = np.argsort(~mask, kind="stable")[:cap]
            k = min(int(mask.sum()), cap)
            assert (got[:k] == want[:k]).all(), (B, cap, frac)
            assert (got[k:] == B).all(), (B, cap, frac)


def test_checkpoint_id_pins_parameters(tmp_path):
    """Resuming with a changed seed or p must MISS the old checkpoint (the
    id pins p value, seed, iterations, OSD order) — a silent stale-counter
    resume was the failure mode being prevented."""
    code = get_code("steane")
    base = dict(shots=256, dec_iterations=10, batch_size=64,
                checkpoint_dir=str(tmp_path))
    r1 = simulate_p(code.Hx, code.Hz, 0.03, SimConfig(rng_seed=21, **base))
    # different seed, same dir: counters must be a fresh (different-stream)
    # computation, not the stale checkpoint's totals
    r2 = simulate_p(code.Hx, code.Hz, 0.03, SimConfig(rng_seed=22, **base))
    fresh = simulate_p(code.Hx, code.Hz, 0.03,
                       SimConfig(rng_seed=22, shots=256, dec_iterations=10,
                                 batch_size=64))
    assert r2.counters == fresh.counters
    # different p, same dir: likewise
    r3 = simulate_p(code.Hx, code.Hz, 0.05, SimConfig(rng_seed=21, **base))
    fresh3 = simulate_p(code.Hx, code.Hz, 0.05,
                        SimConfig(rng_seed=21, shots=256, dec_iterations=10,
                                  batch_size=64))
    assert r3.counters == fresh3.counters
    assert r3.counters != r1.counters


def test_checkpoint_id_pins_code_layout_and_decoder_knobs(tmp_path):
    """The id digests the code matrices, the chunk layout (batch/tile), and
    every decoder knob: changing any of them must write a NEW checkpoint
    file (a shared checkpoint_dir cannot collide across codes, and a
    resumed run cannot reinterpret chunks_done under a different chunk
    size — round-3 verdict weak #1 / ADVICE #1)."""
    import os

    def n_ckpts():
        return len([f for f in os.listdir(tmp_path) if f.endswith(".json")])

    code = get_code("steane")
    base = dict(shots=256, dec_iterations=10, rng_seed=21,
                checkpoint_dir=str(tmp_path))
    simulate_p(code.Hx, code.Hz, 0.03, SimConfig(batch_size=64, **base))
    assert n_ckpts() == 1
    # changed batch size -> different chunk layout -> new id
    simulate_p(code.Hx, code.Hz, 0.03, SimConfig(batch_size=128, **base))
    assert n_ckpts() == 2
    # different code, same dir and otherwise identical parameters -> new id,
    # and the counters must come from a fresh computation
    shor = get_code("shor")
    r = simulate_p(shor.Hx, shor.Hz, 0.03, SimConfig(batch_size=64, **base))
    assert n_ckpts() == 3
    fresh = simulate_p(shor.Hx, shor.Hz, 0.03,
                       SimConfig(shots=256, dec_iterations=10, rng_seed=21,
                                 batch_size=64))
    assert r.counters == fresh.counters
    # counter-affecting decoder knobs (ADVICE #1): layer_compat, bf_residual
    simulate_p(code.Hx, code.Hz, 0.03,
               SimConfig(batch_size=64, dec_schedule="L", **base))
    assert n_ckpts() == 4
    simulate_p(code.Hx, code.Hz, 0.03,
               SimConfig(batch_size=64, dec_schedule="L", layer_compat=True,
                         **base))
    assert n_ckpts() == 5
    simulate_p(code.Hx, code.Hz, 0.03,
               SimConfig(batch_size=64, dec_type="BF", **base))
    assert n_ckpts() == 6
    simulate_p(code.Hx, code.Hz, 0.03,
               SimConfig(batch_size=64, dec_type="BF", bf_residual="bool",
                         **base))
    assert n_ckpts() == 7


def test_sort_window_bit_exact():
    """Difficulty-ordered shot blocking (_sort_records) must not change any
    counter: per-shot decode results are lane-independent and counters are
    order-invariant integer sums, so sorting is pure block densification.
    Covers the plain path and the OSD-deferral path (records permuted
    before compaction), plus a partial final chunk (validity column rides
    the permutation)."""
    code = get_code("lp04_0")
    base = dict(shots=1500, dec_type="MS", dec_iterations=50, rng_seed=21,
                batch_size=512, dispatch_chunks=2)
    r_sorted = simulate_p(code.Hx, code.Hz, 0.05,
                          SimConfig(sort_window=256, **base))
    r_plain = simulate_p(code.Hx, code.Hz, 0.05,
                         SimConfig(sort_window=0, **base))
    assert r_sorted.counters == r_plain.counters
    assert r_sorted.avg_iterations_x == r_plain.avg_iterations_x
    assert r_sorted.avg_iterations_z == r_plain.avg_iterations_z

    osd = dict(shots=1024, dec_type="BP", dec_iterations=16, rng_seed=9,
               batch_size=512, osd_order=1, dispatch_chunks=2)
    r_s = simulate_p(code.Hx, code.Hz, 0.07,
                     SimConfig(sort_window=256, **osd))
    r_p = simulate_p(code.Hx, code.Hz, 0.07, SimConfig(sort_window=0, **osd))
    assert r_s.counters == r_p.counters
    assert r_s.avg_iterations_x == r_p.avg_iterations_x


def test_group_cascade_bit_exact(monkeypatch):
    """The group-deferred cascade (head decode in-chunk, dense group-level
    refinement windows) must reproduce the in-chunk cascade counters
    BIT-EXACTLY — determinism makes every per-shot result identical, so
    this pins the deferral/compaction/window bookkeeping."""
    import os

    code = get_code("lp04_0")
    base = dict(shots=2048, dec_type="MS", dec_iterations=50, rng_seed=13,
                batch_size=512, dispatch_chunks=4)
    monkeypatch.setenv("QLDPC_GROUP_CASCADE", "1")
    r_new = simulate_p(code.Hx, code.Hz, 0.06, SimConfig(**base))
    monkeypatch.delenv("QLDPC_GROUP_CASCADE")
    r_old = simulate_p(code.Hx, code.Hz, 0.06, SimConfig(**base))
    assert r_new.counters == r_old.counters
    assert r_new.avg_iterations_x == r_old.avg_iterations_x
    assert r_new.avg_iterations_z == r_old.avg_iterations_z


def test_group_cascade_with_osd_bit_exact(monkeypatch):
    """Same pin with OSD in the loop: window-level OSD (posteriors from the
    group refinement decode) equals the per-chunk OSD-deferral path."""
    code = get_code("lp04_0")
    base = dict(shots=1024, dec_type="BP", dec_iterations=16, rng_seed=5,
                batch_size=512, osd_order=1, dispatch_chunks=2)
    monkeypatch.setenv("QLDPC_GROUP_CASCADE", "1")
    r_new = simulate_p(code.Hx, code.Hz, 0.07, SimConfig(**base))
    monkeypatch.delenv("QLDPC_GROUP_CASCADE")
    r_old = simulate_p(code.Hx, code.Hz, 0.07, SimConfig(**base))
    assert r_new.counters == r_old.counters
    assert r_new.avg_iterations_x == r_old.avg_iterations_x


def test_group_cascade_overflow_fallback():
    """A chunk whose stragglers exceed the deferral capacity must fall back
    to the full in-chunk cascade (counters equal the disabled-path run) —
    p high enough that >F shots fail the 4-iteration head."""
    import os

    code = get_code("lp04_0")
    base = dict(shots=2048, dec_type="MS", dec_iterations=16, rng_seed=7,
                batch_size=2048)
    os.environ["QLDPC_GROUP_CASCADE"] = "1"
    try:
        r_new = simulate_p(code.Hx, code.Hz, 0.30, SimConfig(**base))
    finally:
        del os.environ["QLDPC_GROUP_CASCADE"]
    r_old = simulate_p(code.Hx, code.Hz, 0.30, SimConfig(**base))
    assert r_new.counters == r_old.counters


def test_first_dispatch_failure_raises():
    """A compile or dispatch failure surfaces to the caller, at the first
    dispatch as mid-run: no rebuild on another backend hides which device
    produced the counters."""
    code = get_code("steane")
    base = dict(shots=512, dec_type="MS", dec_iterations=10, rng_seed=4,
                batch_size=256)
    pipe = ShotPipeline(code.Hx, code.Hz, SimConfig(**base))

    def boom(*a, **k):
        raise RuntimeError("synthetic compile failure")

    pipe._multi_counts = boom
    with pytest.raises(RuntimeError, match="synthetic compile failure"):
        simulate_p(code.Hx, code.Hz, 0.03, SimConfig(**base), pipeline=pipe)

    pipe2 = ShotPipeline(code.Hx, code.Hz, SimConfig(**base))
    orig2 = pipe2._multi_counts
    calls = {"m": 0}

    def boom_later(*a, **k):
        calls["m"] += 1
        if calls["m"] == 1:
            return orig2(*a, **k)
        raise RuntimeError("synthetic mid-run failure")

    pipe2._multi_counts = boom_later
    pipe2.dispatch_chunks = 1
    with pytest.raises(RuntimeError, match="mid-run"):
        simulate_p(code.Hx, code.Hz, 0.03, SimConfig(**base),
                   pipeline=pipe2)
