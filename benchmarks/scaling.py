"""Shot-sharded scaling harness.

Two jobs:
  1. Layout-invariance: identical total counters on 1 device vs an N-device
     mesh (the RNG tile stream makes integer counter sums bit-exact across
     layouts — SURVEY.md §4.4). This is the correctness half of "≥85% linear
     scaling" (BASELINE.md): scaling results only count if the sharded run
     computes the same thing.
  2. Weak-scaling throughput per device count.

On a multi-GPU host this measures mesh scaling; with JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=8 it is an 8-virtual-device
functional demonstration (absolute CPU throughput is not the story).

Usage: python benchmarks/scaling.py [--code lp118_0] [--shots 8192]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def run(code_name: str, shots: int, dec_iterations: int, n_dev: int,
        batch: int, p: float):
    import jax
    import numpy as np

    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.engine.montecarlo import ShotPipeline, SimConfig, simulate_p
    from qldpcsim_jax.parallel.mesh import make_mesh

    code = get_code(code_name)
    mesh = make_mesh(np.asarray(jax.devices()[:n_dev])) if n_dev > 1 else None
    cfg = SimConfig(shots=shots, dec_type="MS", dec_iterations=dec_iterations,
                    dec_schedule="L", batch_size=batch, rng_seed=0, mesh=mesh,
                    device="default")
    pipe = ShotPipeline(code.Hx, code.Hz, cfg)
    r = simulate_p(code.Hx, code.Hz, p, cfg, pipeline=pipe)     # compile+run
    t0 = time.perf_counter()
    r = simulate_p(code.Hx, code.Hz, p, cfg, pipeline=pipe)     # warm
    dt = time.perf_counter() - t0
    return r, shots / dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--code", default="lp118_0")
    ap.add_argument("--shots", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--p", type=float, default=0.04)
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax

    n_avail = len(jax.devices())
    dev_counts = args.devices or sorted({1, min(2, n_avail), min(4, n_avail),
                                         n_avail})
    rows = []
    base_counters = None
    base_sps = None
    for nd in dev_counts:
        if args.shots % (64 * nd):
            continue
        r, sps = run(args.code, args.shots, args.iters, nd,
                     batch=args.shots, p=args.p)
        if base_counters is None:
            base_counters, base_sps = r.counters, sps
        bitexact = r.counters == base_counters
        rows.append({
            "devices": nd, "code": args.code, "shots": args.shots,
            "qBLER": r.qbler, "counters_bitexact_vs_1dev": bool(bitexact),
            "shots_per_s": round(sps, 1),
            "scaling_efficiency": round(sps / (base_sps * nd), 3),
        })
        print(json.dumps(rows[-1]), flush=True)
        assert bitexact, f"counters diverged at {nd} devices"
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
