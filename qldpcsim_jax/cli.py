"""Command-line front-end.

Flag-compatible with the reference CLI (simulator.py:351-374): --Hx --Hz --p
--shots --rngSeed --decType --decIterations --decSchedule --OSDorder, plus
extensions (--code to use the built-in library, --batch, --mesh,
--out for JSON results, --checkpointDir for resumable sweeps, --layerCompat
for reference cross-wired layer parity).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Quantum-LDPC depolarizing-channel simulator in JAX "
                    "(qBLER Monte Carlo for CSS codes).")
    src = parser.add_argument_group("code input")
    src.add_argument("--Hx", help="Path to Hx parity-check matrix (.npy or text).")
    src.add_argument("--Hz", help="Path to Hz parity-check matrix (.npy or text).")
    src.add_argument("--code", help="Built-in code name (shor, steane, bicycle, "
                                    "tanner, lp04_0..3, lp118_0..2) instead of --Hx/--Hz.")
    parser.add_argument("--p", type=float, nargs="+", required=True,
                        help="Depolarizing probability (one or more points).")
    parser.add_argument("--shots", type=int, default=1000,
                        help="Number of Monte Carlo shots.")
    parser.add_argument("--rngSeed", type=int, default=None, help="RNG seed.")
    parser.add_argument("--decType", choices=["NG", "BF", "MS", "BP"], default="MS",
                        help="Decoder type: [NG] Naive Greedy; [BF] Bit-Flipping; "
                             "[MS] Min-Sum; [BP] Belief Propagation.")
    parser.add_argument("--decIterations", type=int, default=99,
                        help="Number of decoding iterations.")
    parser.add_argument("--decSchedule", choices=["F", "L", "S"], default="F",
                        help="Decoder scheduling: [F] flooding; [L] layered; [S] serial.")
    parser.add_argument("--OSDorder", type=int, default=-1,
                        help="Ordered Statistics Decoding order (-1 = disable).")
    ex = parser.add_argument_group("execution")
    ex.add_argument("--batch", type=int, default=0,
                     help="Shots per compiled chunk (0 = auto).")
    ex.add_argument("--mesh", action="store_true",
                     help="Shard shots over all visible devices.")
    ex.add_argument("--mesh-p", type=int, default=0, metavar="N",
                     help="Shard the p-sweep over a ('p','shots') 2-D mesh "
                          "with N p-rows: one dispatch decodes N p-values "
                          "(per-p counters bit-exact vs the serial sweep).")
    ex.add_argument("--execMode", choices=("auto", "shardmap", "perdevice"),
                     default="auto",
                     help="Sharded execution strategy (with --mesh/--mesh-p): "
                          "shardmap (one partitioned program + psum; auto) "
                          "or perdevice (one single-device dispatch per "
                          "device + host-side reduction; bit-exact "
                          "counters).")
    ex.add_argument("--layerCompat", action="store_true",
                     help="Reproduce the reference's cross-wired layer derivation.")
    ex.add_argument("--impl",
                     choices=("auto", "edge", "mxu", "seq", "qc"),
                     default="auto",
                     help="Decoder implementation override: edge (bit-exact "
                          "reference-parity path), mxu (incidence-matmul), "
                          "seq (row-sequential), qc (Triton circulant "
                          "min-sum kernel, GPU only); auto picks per "
                          "platform/structure.")
    ex.add_argument("--device", choices=("auto", "cpu"),
                     default="auto",
                     help="Execution backend: auto runs on the session's "
                          "default device, cpu on the CPU backend.")
    ex.add_argument("--validateEncoding", action="store_true",
                     help="Run the full encode->corrupt->extract pipeline "
                          "(GF(2) codeword frames; counters provably equal "
                          "the frame-free channel).")
    ex.add_argument("--bfResidual", choices=("mod2", "bool"), default="mod2",
                     help="BF residual semantics: mod2 (parity, default) or "
                          "bool (reference's any-overlap residual — see "
                          "DIVERGENCES.md).")
    ex.add_argument("--checkpointDir", default=None,
                     help="Directory for resumable per-p-point counter checkpoints.")
    ex.add_argument("--out", default=None, help="Write results as JSON lines.")
    ex.add_argument("--quiet", action="store_true", help="Suppress progress lines.")
    ex.add_argument("--profile", default=None, metavar="DIR",
                     help="Write a jax.profiler trace of the sweep to DIR "
                          "(view with TensorBoard / xprof).")
    return parser


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.code:
        from qldpcsim_jax.codes import get_code

        code = get_code(args.code)
        Hx, Hz = np.asarray(code.Hx), np.asarray(code.Hz)
    elif args.Hx and args.Hz:
        from qldpcsim_jax.codes.loader import load_matrix

        Hx, Hz = load_matrix(args.Hx), load_matrix(args.Hz)
    else:
        print("error: provide either --code or both --Hx and --Hz", file=sys.stderr)
        return 2

    print("\n   Command line arguments:")
    print(args)
    print("")

    p = np.asarray(args.p, dtype=np.float64)
    if p.size == 0 or p.min() < 0.0 or p.max() > 1.0:
        print("error: --p values must lie in [0, 1]", file=sys.stderr)
        return 2

    from qldpcsim_jax.engine.montecarlo import ShotPipeline, SimConfig, simulate_p
    from qldpcsim_jax.engine.results import format_results_table

    mesh = None
    if args.mesh or args.mesh_p:
        from qldpcsim_jax.parallel import make_mesh, multihost_init

        multihost_init()
        if not args.mesh_p:
            mesh = make_mesh()

    cfg = SimConfig(
        shots=args.shots, dec_type=args.decType, dec_iterations=args.decIterations,
        dec_schedule=args.decSchedule, osd_order=args.OSDorder,
        rng_seed=args.rngSeed, batch_size=args.batch, layer_compat=args.layerCompat,
        bf_residual=args.bfResidual, validate_encoding=args.validateEncoding,
        impl=args.impl, device=args.device,
        mesh=mesh, mesh_p=args.mesh_p, exec_mode=args.execMode,
        checkpoint_dir=args.checkpointDir, progress=not args.quiet,
    )
    from qldpcsim_jax.utils.profiling import trace_context

    with trace_context("p_sweep", args.profile):
        if cfg.mesh_p:
            from qldpcsim_jax.engine.montecarlo import simulate_sweep

            results = simulate_sweep(Hx, Hz, p, cfg)
        else:
            pipe = ShotPipeline(Hx, Hz, cfg)
            results = [simulate_p(Hx, Hz, pT, cfg, pipeline=pipe, p_index=i)
                       for i, pT in enumerate(p)]

    print(format_results_table(results))
    if args.out:
        with open(args.out, "w") as f:
            for r in results:
                f.write(r.to_json() + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
