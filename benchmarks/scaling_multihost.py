"""Multi-PROCESS (multi-host-shaped) scaling benchmark.

BASELINE.md north star: ">=85% linear scaling from 1 to 2 hosts". This
harness measures
the real thing the multi-host path adds — jax.distributed initialization,
cross-process device visibility, and psum-reduced counters — with N OS
processes on the CPU backend (1 device per process, exactly the SURVEY §4.4
shape; the compute scales over host cores, standing in for per-host chips).

Each process runs the SAME global workload definition; shots shard over the
global mesh, so N processes each decode shots/N. Reported efficiency =
(t_1proc / t_Nproc) / N over the warm (compile-excluded) window. Counters
are asserted bit-exact across process counts (layout-invariant RNG tiles).

Every process is pinned to ONE core (taskset): XLA's CPU client otherwise
parallelizes a single process over all host cores, which would make the
1-process baseline a whole-host number and understate scaling — on a real
cluster each host drives its own cards, which one pinned core models.

Usage: python benchmarks/scaling_multihost.py [--procs 1 2] [--shots 16384]
Emits one JSON line per process count.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import json, os, sys, time
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, %(root)r)
    from qldpcsim_jax.parallel.mesh import multihost_init, make_mesh

    multihost_init()
    import numpy as np
    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.engine.montecarlo import ShotPipeline, SimConfig, simulate_p

    code = get_code(os.environ["SMH_CODE"])
    shots = int(os.environ["SMH_SHOTS"])
    batch = int(os.environ["SMH_BATCH"])
    mesh = make_mesh() if jax.device_count() > 1 else None
    cfg = SimConfig(shots=shots, dec_type="MS", dec_iterations=20,
                    dec_schedule="L", batch_size=batch, rng_seed=0,
                    mesh=mesh, device="default")
    pipe = ShotPipeline(code.Hx, code.Hz, cfg)
    r = simulate_p(code.Hx, code.Hz, 0.05, cfg, pipeline=pipe)  # compile
    t0 = time.perf_counter()
    r = simulate_p(code.Hx, code.Hz, 0.05, cfg, pipeline=pipe)  # warm
    dt = time.perf_counter() - t0
    if jax.process_index() == 0:
        with open(os.environ["SMH_OUT"], "w") as f:
            json.dump({"warm_s": dt, "counters": r.counters}, f)
""")


def run_procs(n: int, code: str, shots: int, batch: int) -> dict:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    # One private directory per process-count run (mktemp is race-prone and
    # would also reuse one path across runs); the result file lives inside.
    with tempfile.TemporaryDirectory(prefix=f"smh{n}_") as tmpdir:
        out = os.path.join(tmpdir, "result.json")
        procs = []
        for i in range(n):
            env = dict(os.environ)
            env.pop("XLA_FLAGS", None)
            env.update(SMH_CODE=code, SMH_SHOTS=str(shots),
                       SMH_BATCH=str(batch), SMH_OUT=out)
            if n > 1:
                env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                           JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(i))
            ncores = os.cpu_count() or 1
            procs.append(subprocess.Popen(
                ["taskset", "-c", str(i % ncores),
                 sys.executable, "-c", _CHILD % {"root": _ROOT}], env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        errs = []
        for i, p in enumerate(procs):
            # communicate() drains the stderr pipe while waiting — wait()
            # with a piped stderr can deadlock if a child fills the buffer.
            _, err = p.communicate(timeout=600)
            if p.returncode:
                errs.append(f"[proc {i} rc={p.returncode}] {err[-2000:]}")
        if not os.path.exists(out):
            # Report EVERY failed child, not just the first — when process 0
            # dies its stderr usually names the real cause even if others
            # exited first/cleanly.
            raise RuntimeError("no result file written; child failures:\n"
                               + ("\n".join(errs) or "(none reported)"))
        if errs:
            raise RuntimeError("\n".join(errs))
        with open(out) as f:
            return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--code", default="lp04_0")
    ap.add_argument("--shots", type=int, default=16384)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    rows = []
    base = None
    for n in args.procs:
        r = run_procs(n, args.code, args.shots, args.batch)
        if base is None:
            base = r
        eff = (base["warm_s"] / r["warm_s"]) / (n / args.procs[0])
        rows.append({
            "processes": n, "code": args.code, "shots": args.shots,
            "warm_s": round(r["warm_s"], 3),
            "counters_bitexact_vs_base": r["counters"] == base["counters"],
            "scaling_efficiency": round(eff, 3),
        })
        print(json.dumps(rows[-1]))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    ok = all(r["counters_bitexact_vs_base"] for r in rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
