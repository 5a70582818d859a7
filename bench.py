"""Flagship throughput on one NVIDIA GPU: LP118_0, normalized min-sum,
layered schedule, 50 iterations, p=0.05, through `simulate_p` (channel
sample + decode of the X and Z components + classification, all on the
card).

Prints the card's name and power limit, then ONE JSON line with warm
decoded shots/s (compile excluded), compile-inclusive wall time and the
qBLER. Fails without a GPU: a CPU number is never reported as the card's.

Usage: python bench.py [--impl auto|edge|mxu|qc] [--shots N]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CODE, P_POINT, MAX_ITER, SCHEDULE, BATCH = "lp118_0", 0.05, 50, "L", 4096


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", default="auto",
                    help="decoder impl: auto|edge|mxu|qc")
    ap.add_argument("--shots", type=int, default=1 << 22)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    from chip_smoke import card_query
    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.engine.montecarlo import SimConfig, simulate_p

    print(f"card: {card_query()}", flush=True)
    code = get_code(CODE)
    r = simulate_p(code.Hx, code.Hz, P_POINT,
                   SimConfig(shots=args.shots, dec_type="MS",
                             dec_iterations=MAX_ITER, dec_schedule=SCHEDULE,
                             batch_size=BATCH, rng_seed=0, impl=args.impl))
    print(json.dumps({
        "metric": f"warm decoded shots/s ({CODE}, MS layered, {MAX_ITER} "
                  f"iters, p={P_POINT}, impl={args.impl})",
        "value": r.shots_per_s_warm, "unit": "shots/s",
        "wall_s": r.wall_time_s, "shots": r.shots, "qBLER": r.qbler,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
