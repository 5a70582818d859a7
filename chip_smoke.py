#!/usr/bin/env python3
"""Smoke test of the shot pipeline on an NVIDIA GPU.

Run from the root of a checkout, on a machine with the card:

    python chip_smoke.py                # phases (a)-(f) on one card
    python chip_smoke.py --four-cards   # the 4-card mesh path and its
                                        # 1-card comparison, nothing else

Phases, one result line each (`[phase] {json}`):
  (a) card      the card's name and power limit (nvidia-smi), device kind
  (b) channel   GPU channel samples of the same tile keys, bit-exact vs CPU
  (c) decoder   the decoder each fast path runs on the card, at LP118_0 and
                LP04_0 widths, against impl="edge" (the bit-exact oracle)
  (d) flagship  LP118_0 min-sum layered, 50 iterations, p=0.05, through
                simulate_p: warm shots/s, compile seconds, memory analysis,
                qBLER within 4 sigma of a CPU run with the same seed
  (e) baselines every BASELINE deployment through simulate_p /
                simulate_sweep, counters within bounds of the CPU run
  (f) timing    decode-only and end-to-end flagship time of the Triton
                kernel, impl="mxu" and impl="edge"

The run fails (non-zero exit) if any phase fails, and exits before any
phase, printing no result, when JAX finds no GPU. The last line is
{"ok": ..., "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FLAGSHIP = dict(code="lp118_0", dec_type="MS", dec_iterations=50,
                dec_schedule="L", p=0.05, batch_size=4096)

# BASELINE deployments (benchmarks/run_configs.py), shots cut for a smoke run:
# (name, code, ps, shots, CPU shots, decoder, iterations, schedule, OSD
# order). The CPU reference decodes the first `CPU shots` of the same tile
# stream; the serial Tanner decode is the slow one on a CPU.
BASELINES = [
    ("1_shor_bp_flood", "shor", [0.01, 0.05], 8192, 8192, "BP", 99, "F", -1),
    ("2_steane_nms_layered", "steane", [0.01, 0.05], 8192, 8192, "MS", 50,
     "L", -1),
    ("3_bicycle_bf", "bicycle", [0.01, 0.03], 8192, 8192, "BF", 50, "F", -1),
    ("3_bicycle_ng", "bicycle", [0.01, 0.03], 8192, 8192, "NG", 0, "F", -1),
    ("4_tanner_ms_serial", "tanner", [0.01, 0.04, 0.07, 0.1], 4096, 512,
     "MS", 30, "S", -1),
    ("5_lp04_bp_osd2", "lp04_0", [0.03], 8192, 8192, "BP", 99, "F", 2),
    ("5_lp118_bp_osd2", "lp118_0", [0.03], 8192, 8192, "BP", 99, "F", 2),
]

# Converged-shot agreement with the edge oracle. The fast paths update the
# posterior incrementally (another floating-point association than the
# oracle's full re-sum, at precision HIGHEST) and the Triton kernel checks
# convergence once per iteration, so a few shots may land differently.
AGREE_TOL = 0.95


def card_query():
    """`name, power.limit` of the cards as nvidia-smi prints them, or None.
    Runs in a child process that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def phase_card(devices):
    card = card_query()
    d = devices[0]
    return {"ok": card is not None, "card": card,
            "device_kind": d.device_kind, "count": len(devices)}


def phase_channel(dev, ref_dev, code="lp118_0", n_tiles=64, tile=64, p=0.05,
                  seed=0):
    """Channel samples and syndromes of the same tile keys on `dev` and on
    `ref_dev`: the threefry stream makes them bit-exact."""
    import jax
    import jax.numpy as jnp

    from qldpcsim_jax.channel.depolarizing import sample_shot_tiles
    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.parallel.mesh import chunk_keys

    c = get_code(code)
    Hx_T = np.asarray(c.Hx, np.float32).T
    Hz_T = np.asarray(c.Hz, np.float32).T
    n = Hx_T.shape[0]
    outs = []
    for d in (dev, ref_dev):
        with jax.default_device(d):
            keys = chunk_keys(jax.random.PRNGKey(seed), 0, n_tiles)
            f = jax.jit(lambda k: sample_shot_tiles(k, jnp.float32(p), n,
                                                    tile, Hx_T, Hz_T))
            outs.append([np.asarray(a) for a in f(keys)])
    same = [bool((a == b).all()) for a, b in zip(*outs)]
    return {"ok": all(same), "shots": n_tiles * tile, "n": n,
            "bit_exact": dict(zip(("err_x", "err_z", "sy_z", "sy_x"), same)),
            "err_x_rate": float(outs[0][0].mean())}


def phase_decoder(dev, codes=("lp118_0", "lp04_0"), impls=("qc", "mxu"),
                  B=4096, max_iter=50, p=0.05, seed=1):
    """Each fast path against impl="edge" on the same device, on channel
    syndromes of the X side (matrix Hz, prior p/3). The Triton kernel ("qc")
    is checked where it applies: on a GPU, for codes it supports."""
    import jax

    from qldpcsim_jax.channel.depolarizing import sample_depolarizing
    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.decoders import (DecoderConfig, TannerGraph,
                                       build_layers, make_decoder)
    from qldpcsim_jax.ops import ms_qc_triton
    from qldpcsim_jax.ops.qc import detect_qc

    plat = dev.platform
    rows, ok = [], True
    for code in codes:
        H = np.asarray(get_code(code).Hz) % 2
        graph, layers = TannerGraph.build(H), build_layers(H, "L")
        qc_ok = plat == "gpu" and ms_qc_triton.supports(
            detect_qc(H), DecoderConfig(dec_type="MS", schedule="L"), layers)
        run = [i for i in impls if i != "qc" or qc_ok]
        with jax.default_device(dev):
            ex, _ = sample_depolarizing(jax.random.PRNGKey(seed), p,
                                        (B, H.shape[1]))
            ex = np.asarray(ex).astype(np.int64)
            syn = ((ex @ H.T) % 2).astype(np.int8)
            res = {}
            for impl in ["edge"] + run:
                cfg = DecoderConfig(dec_type="MS", max_iter=max_iter,
                                    schedule="L", impl=impl, platform=plat)
                r = jax.jit(make_decoder(graph, cfg, layers=layers))(
                    syn, p / 3.0)
                res[impl] = {k: np.asarray(getattr(r, k))
                             for k in ("e_hat", "converged", "n_iter")}
        for impl in run:
            e, t = res["edge"], res[impl]
            both = e["converged"] & t["converged"]
            conv_agree = float((e["converged"] == t["converged"]).mean())
            e_agree = (float((e["e_hat"][both] == t["e_hat"][both])
                             .all(axis=1).mean()) if both.any() else 1.0)
            conv = t["converged"]
            consistent = float((((t["e_hat"].astype(np.int64) @ H.T) % 2
                                 == syn)[conv].all(axis=1).mean())
                               if conv.any() else 0.0)
            good = (conv_agree >= AGREE_TOL and e_agree >= AGREE_TOL
                    and consistent == 1.0)
            ok &= good
            rows.append({"code": code, "impl": impl, "B": B,
                         "converged": float(conv.mean()),
                         "converged_agreement": conv_agree,
                         "e_hat_agreement": e_agree,
                         "syndrome_consistency": consistent, "ok": good})
    return {"ok": ok, "tolerance": AGREE_TOL,
            "reason": "incremental posterior association (precision "
                      "HIGHEST) and per-iteration convergence checks",
            "rows": rows}


def _qbler_bound(a, b):
    """|qBLER_a - qBLER_b| against 4 sigma of the difference (sigma floored
    at one shot of each run)."""
    qa, qb = a.qbler, b.qbler
    sig = math.sqrt(max(qa * (1 - qa), 1.0 / a.shots) / a.shots
                    + max(qb * (1 - qb), 1.0 / b.shots) / b.shots)
    return abs(qa - qb), 4.0 * sig


def phase_flagship(shots=1 << 21, cpu_shots=1 << 14, seed=0,
                   flagship=FLAGSHIP):
    """The flagship through simulate_p on the default device, and its qBLER
    against a CPU run of the same seed (the CPU run's shots are the first
    `cpu_shots` of the same tile stream)."""
    import jax
    import jax.numpy as jnp

    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.engine.montecarlo import (ShotPipeline, SimConfig,
                                                simulate_p)
    from qldpcsim_jax.parallel.mesh import chunk_keys

    f = dict(flagship)
    code, p = get_code(f.pop("code")), f.pop("p")
    cfg = SimConfig(shots=shots, rng_seed=seed, **f)
    pipe = ShotPipeline(code.Hx, code.Hz, cfg)
    g = max(1, min(pipe.dispatch_chunks, -(-shots // pipe.batch)))
    keys = chunk_keys(jax.random.PRNGKey(seed), 0,
                      g * pipe.tiles_per_chunk).reshape(
                          g, pipe.tiles_per_chunk, -1)
    t0 = time.perf_counter()
    compiled = pipe._multi_counts.lower(
        keys, jnp.float32(p), jnp.full((g,), pipe.batch, jnp.int32)).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    mem = ({k: int(getattr(mem, k)) for k in dir(mem)
            if k.endswith("_in_bytes")} if mem is not None else None)
    r = simulate_p(code.Hx, code.Hz, p, cfg, pipeline=pipe)
    r_cpu = simulate_p(code.Hx, code.Hz, p,
                       SimConfig(shots=cpu_shots, rng_seed=seed, device="cpu",
                                 **f))
    diff, bound = _qbler_bound(r, r_cpu)
    return {"ok": diff <= bound and r.qbler < 1.0,
            "card": card_query(), "shots": shots,
            "warm_shots_per_s": r.shots_per_s_warm,
            "warm_shots": r.warm_shots, "compile_s": compile_s,
            "memory_analysis": mem, "qBLER": r.qbler,
            "qBLER_cpu": r_cpu.qbler, "cpu_shots": cpu_shots,
            "diff": diff, "bound_4sigma": bound,
            "avg_iters": [r.avg_iterations_x, r.avg_iterations_z],
            "avg_iters_cpu": [r_cpu.avg_iterations_x,
                              r_cpu.avg_iterations_z]}


def phase_baselines(specs=BASELINES, seed=0):
    """Every BASELINE deployment on the default device and on the CPU with
    the same seed: the channel stream is bit-exact, so the counters differ
    only where decoding arithmetic does, and the qBLERs must agree within
    4 sigma. The Tanner p-sweep goes through simulate_sweep."""
    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.engine.montecarlo import (ShotPipeline, SimConfig,
                                                simulate_p, simulate_sweep)

    rows, ok = [], True
    for (name, code_name, ps, shots, cpu_shots, dec, iters, sched,
         osd) in specs:
        code = get_code(code_name)
        runs = {}
        for dev, n in (("auto", shots), ("cpu", cpu_shots)):
            cfg = SimConfig(shots=n, dec_type=dec, dec_iterations=iters,
                            dec_schedule=sched, osd_order=osd, rng_seed=seed,
                            device=dev)
            t0 = time.perf_counter()
            if sched == "S":
                res = simulate_sweep(code.Hx, code.Hz, ps,
                                     dataclasses.replace(cfg, mesh_p=1))
            else:
                pipe = ShotPipeline(code.Hx, code.Hz, cfg)
                res = [simulate_p(code.Hx, code.Hz, p, cfg, pipeline=pipe,
                                  p_index=i) for i, p in enumerate(ps)]
            runs[dev] = (res, time.perf_counter() - t0)
        for (rg, rc) in zip(runs["auto"][0], runs["cpu"][0]):
            diff, bound = _qbler_bound(rg, rc)
            good = diff <= bound
            ok &= good
            rows.append({"config": name, "p": rg.p, "shots": shots,
                         "cpu_shots": cpu_shots,
                         "qBLER": rg.qbler, "qBLER_cpu": rc.qbler,
                         "counters_equal": rg.counters == rc.counters,
                         "diff": diff, "bound_4sigma": bound, "ok": good})
        rows[-1]["wall_s"] = runs["auto"][1]
    return {"ok": ok, "rows": rows}


def _median_time(fn, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_timing(impls=("qc", "mxu", "edge"), B=4096, e2e_shots=1 << 19,
                 dispatch_chunks=16, reps=5, seed=2, flagship=FLAGSHIP):
    """Warm decode-only time (one X-side decode of B channel shots through
    the full cascade) and warm end-to-end shots/s through simulate_p, per
    implementation, on the default device."""
    import jax
    import jax.numpy as jnp

    from qldpcsim_jax.channel.depolarizing import sample_depolarizing
    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.decoders import (DecoderConfig, TannerGraph,
                                       build_layers, make_decoder)
    from qldpcsim_jax.engine.montecarlo import SimConfig, simulate_p

    f = dict(flagship)
    code, p = get_code(f.pop("code")), f.pop("p")
    H = np.asarray(code.Hz) % 2
    graph, layers = TannerGraph.build(H), build_layers(H, f["dec_schedule"])
    ex, _ = sample_depolarizing(jax.random.PRNGKey(seed), p, (B, H.shape[1]))
    syn = jnp.asarray((np.asarray(ex).astype(np.int64) @ H.T) % 2, jnp.int8)
    rows = []
    for impl in impls:
        cfg = DecoderConfig(dec_type=f["dec_type"],
                            max_iter=f["dec_iterations"],
                            schedule=f["dec_schedule"], impl=impl)
        dec = jax.jit(make_decoder(graph, cfg, layers=layers))
        jax.block_until_ready(dec(syn, p / 3.0))
        t_dec = _median_time(
            lambda: jax.block_until_ready(dec(syn, p / 3.0)), reps)
        r = simulate_p(code.Hx, code.Hz, p,
                       SimConfig(shots=e2e_shots, rng_seed=seed, impl=impl,
                                 dispatch_chunks=dispatch_chunks, **f))
        rows.append({"impl": impl, "decode_ms": 1e3 * t_dec, "B": B,
                     "e2e_warm_shots_per_s": r.shots_per_s_warm,
                     "e2e_shots": e2e_shots, "qBLER": r.qbler})
    return {"ok": all(r["e2e_warm_shots_per_s"] > 0 for r in rows),
            "card": card_query(), "rows": rows}


def phase_four_cards(devices, shots=1 << 18, sweep_shots=1 << 16,
                     ps=(0.03, 0.05, 0.07, 0.09), seed=3,
                     flagship=FLAGSHIP):
    """simulate_p on a 4-card shard_map mesh and simulate_sweep with mesh_p
    2 and 4, each against the 1-card run of the same seed. The RNG tile
    contract makes the counters bit-exact."""
    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.engine.montecarlo import (ShotPipeline, SimConfig,
                                                simulate_p, simulate_sweep)
    from qldpcsim_jax.parallel import make_mesh

    if len(devices) < 4:
        return {"ok": False, "error": f"needs 4 devices, found {len(devices)}"}
    f = dict(flagship)
    code, p = get_code(f.pop("code")), f.pop("p")
    mesh = make_mesh(devices[:4])
    rows, ok = [], True

    def compare(what, a, b):
        nonlocal ok
        same = (a.counters == b.counters
                and a.avg_iterations_x == b.avg_iterations_x
                and a.avg_iterations_z == b.avg_iterations_z)
        ok &= same
        rows.append({"path": what, "p": a.p, "bit_exact": same,
                     "qBLER_1card": b.qbler, "qBLER": a.qbler,
                     "warm_shots_per_s": a.shots_per_s_warm,
                     "warm_shots_per_s_1card": b.shots_per_s_warm})

    one = SimConfig(shots=shots, rng_seed=seed, **f)
    r1 = simulate_p(code.Hx, code.Hz, p, one)
    r4 = simulate_p(code.Hx, code.Hz, p,
                    SimConfig(shots=shots, rng_seed=seed, mesh=mesh, **f))
    compare("simulate_p mesh=4", r4, r1)
    sw = SimConfig(shots=sweep_shots, rng_seed=seed, **f)
    pipe = ShotPipeline(code.Hx, code.Hz, sw)
    serial = [simulate_p(code.Hx, code.Hz, pT, sw, pipeline=pipe, p_index=i)
              for i, pT in enumerate(ps)]
    for n_p in (2, 4):
        swept = simulate_sweep(
            code.Hx, code.Hz, list(ps),
            SimConfig(shots=sweep_shots, rng_seed=seed, mesh=mesh,
                      mesh_p=n_p, **f))
        for a, b in zip(swept, serial):
            compare(f"simulate_sweep mesh_p={n_p}", a, b)
    return {"ok": ok, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh path and its 1-card "
                         "comparison")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 2
    from qldpcsim_jax.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    cpu = jax.devices("cpu")[0]

    card = phase_card(devices)
    print(f"card: {card['card']}", flush=True)
    if args.four_cards:
        phases = [("card", lambda: card),
                  ("four_cards", lambda: phase_four_cards(devices))]
    else:
        phases = [("card", lambda: card),
                  ("channel", lambda: phase_channel(devices[0], cpu)),
                  ("decoder", lambda: phase_decoder(devices[0])),
                  ("flagship", phase_flagship),
                  ("baselines", phase_baselines),
                  ("timing", phase_timing)]
    ok = True
    t_start = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception as e:  # a phase that raises has failed
            res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        res["seconds"] = time.perf_counter() - t0
        ok &= bool(res["ok"])
        print(f"[{name}] {json.dumps(res, default=str)}", flush=True)
    print(f"total seconds: {time.perf_counter() - t_start:.1f}", flush=True)
    d = devices[0]
    print(json.dumps({"ok": ok, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
