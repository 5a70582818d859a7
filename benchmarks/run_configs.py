"""Run the five BASELINE.json benchmark configs end-to-end and emit one JSON
line per config (qBLER, failure counts, average iterations, decoded shots/s).

Usage: python benchmarks/run_configs.py [--shots-scale S] [--out FILE]

Configs (BASELINE.json "configs"):
  1. Shor [[9,1,3]], BP flooding, p=[0.01, 0.05], 1000 shots
  2. Steane, normalized min-sum, layered, 50 iterations
  3. Bicycle, bit-flipping + naive-greedy, flooding
  4. QC-LDPC Tanner, MS serial schedule, p-sweep [0.01..0.1]
  5. LP04/LP118, BP + OSD-2, 1e5 shots
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_config(name, code_name, p_list, shots, dec_type, iters, schedule,
               osd_order=-1, seed=0, batch=0):
    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.engine.montecarlo import ShotPipeline, SimConfig, simulate_p

    code = get_code(code_name)
    cfg = SimConfig(shots=shots, dec_type=dec_type, dec_iterations=iters,
                    dec_schedule=schedule, osd_order=osd_order, rng_seed=seed,
                    batch_size=batch)
    pipe = ShotPipeline(code.Hx, code.Hz, cfg)
    rows = []
    for i, p in enumerate(p_list):
        r = simulate_p(code.Hx, code.Hz, p, cfg, pipeline=pipe, p_index=i)
        rows.append({
            "config": name, "code": code_name, "decoder": dec_type,
            "schedule": schedule, "osd": osd_order, "p": p, "shots": shots,
            "qBLER": r.qbler, "qBLER_honest": r.qbler_honest,
            "DecFailures_X": r.counters["DecFailures_X"],
            "DecFailures_Z": r.counters["DecFailures_Z"],
            "logicalErrors_X": r.counters["logicalErrors_X"],
            "logicalErrors_Z": r.counters["logicalErrors_Z"],
            "avg_iters_X": round(r.avg_iterations_x, 3),
            "avg_iters_Z": round(r.avg_iterations_z, 3),
            "shots_per_s": round(r.shots_per_s, 1),
            "shots_per_s_warm": round(r.shots_per_s_warm, 1)
            if r.shots_per_s_warm == r.shots_per_s_warm else None,
        })
        print(json.dumps(rows[-1]), flush=True)  # incremental progress
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shots-scale", type=float, default=1.0,
                    help="scale factor on shot counts (quick runs)")
    ap.add_argument("--only", default=None,
                    help="comma-separated config name prefixes to run "
                         "(e.g. '1,3' or '5_lp118')")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    s = args.shots_scale

    specs = [
        # 1. Shor, BP flooding (BASELINE config 1)
        ("1_shor_bp_flood", "shor", [0.01, 0.05], int(1000 * s), "BP", 99, "F", -1),
        # 2. Steane, NMS layered 50 it (config 2)
        ("2_steane_nms_layered", "steane", [0.01, 0.03, 0.05], int(20000 * s), "MS", 50, "L", -1),
        # 3. Bicycle, BF + NG flooding (config 3)
        ("3_bicycle_bf", "bicycle", [0.01, 0.03], int(5000 * s), "BF", 50, "F", -1),
        ("3_bicycle_ng", "bicycle", [0.01, 0.03], int(5000 * s), "NG", 0, "F", -1),
        # 4. Tanner, MS serial, p-sweep (config 4)
        ("4_tanner_ms_serial", "tanner",
         list(np.round(np.linspace(0.01, 0.1, 4), 3)), int(65536 * s), "MS", 30, "S", -1),
        # 5. LP04/LP118, BP + OSD-2 (config 5). 99 iterations = the
        # reference CLI default (simulator.py:356); deeper BP also sends
        # fewer shots into OSD.
        ("5_lp04_bp_osd2", "lp04_0", [0.03], int(1048576 * s), "BP", 99, "F", 2),
        ("5_lp118_bp_osd2", "lp118_0", [0.03], int(2621440 * s), "BP", 99, "F", 2),
    ]
    if args.only:
        prefixes = tuple(x.strip() for x in args.only.split(","))
        specs = [sp for sp in specs if sp[0].startswith(prefixes)]

    t0 = time.time()
    rows = []
    for (name, code, p_list, shots, dec, iters, sched, osd) in specs:
        rows += run_config(name, code, p_list, shots, dec, iters, sched,
                           osd_order=osd)

    out = "\n".join(json.dumps(r) for r in rows)
    print(f"# total wall time: {time.time()-t0:.1f}s", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
