"""Statistical qBLER parity harness: this framework vs reference semantics.

The accuracy bar (BASELINE.md) is "qBLER curves match the reference within
Monte-Carlo confidence bounds". Two oracle modes (--oracle):

  * native (default, fast): an independent reference-semantics oracle —
      MS rows:      the native batched C++ decoder (csrc/gf2core.cpp
                    ms_decode_cpu, exact decoders.py:110-182 semantics);
      BP rows:      the native STRICT-reference-numerics C++ decoder
                    (bp_decode_cpu: float64, eps=1e-9, clamp-by-subtraction —
                    decoders.py:235,256-258), with OSD post-decoding of
                    failed shots by the native C++ OSD (osd_decode_cpu);
      BF/NG rows:   the per-shot NumPy oracle (tests/oracle.py).
  * reference: the LITERAL reference decoders, path-imported from
    /root/reference/qLDPCsim (tests/refimport.py) and called per shot with
    the reference's own OSD wiring (OSDorder passed into MS/BP,
    decoders.py:179-180,287-288). This mode is 3-5 orders of magnitude
    slower than the engine, so oracle shot counts are reduced per config
    (the z-test bound widens accordingly); per-shot bit-exactness against
    the same functions is covered by tests/test_reference_parity.py.
    Note reference OSD-2 equals reference OSD-0 (enumeration aliasing,
    DIVERGENCES.md L4, pinned by test_reference_osd2_is_osd0), so OSD rows
    in this mode compare our corrected OSD-2 against the reference's
    effective OSD-0.

Channel: independently sampled at the reference's marginals (DEPOLARIZE1(p):
X/Y/Z each w.p. p/3 => errX marginal 2p/3, errX&errZ jointly p/3;
simulator.py:99-118). Classification: the reference's event tests
(simulator.py:291-303), vectorized.

For each config both sides estimate qBLER = 1 - (exact + degen)/shots; the
test is a two-proportion z-test: |q_new - q_ref| <= Z * sqrt(pv*(1/N + 1/M)),
pv = pooled variance, Z = 4 (false-alarm ~6e-5 per config). Shot counts are
sized so every bound is <= 0.02 (oracle side >= 10^4 per config).

Usage: python benchmarks/parity.py [--scale S] [--out FILE]
Emits one JSON line per config with both estimates and PASS/FAIL.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tests"))
sys.path.insert(0, _ROOT)

Z = 4.0


def _sample_channel(code, p, shots, seed):
    Hx = np.asarray(code.Hx) % 2
    Hz = np.asarray(code.Hz) % 2
    n = Hx.shape[1]
    rng = np.random.default_rng(seed + 7919)
    u = rng.random((shots, n))
    err_x = u < 2 * p / 3
    err_z = (u >= p / 3) & (u < p)
    sy_z = (err_x.astype(np.int64) @ Hz.T.astype(np.int64)) % 2
    sy_x = (err_z.astype(np.int64) @ Hx.T.astype(np.int64)) % 2
    return Hx, Hz, err_x, err_z, sy_z, sy_x


def _decode_side_batch_reference(H, syn, p, dec_type, iters, layers,
                                 osd_order):
    """Decode all shots of one side with the LITERAL reference decoders."""
    from refimport import load_reference

    ref = load_reference()[1]
    B = syn.shape[0]
    es = np.zeros((B, H.shape[1]), np.int8)
    for s in range(B):
        if dec_type == "MS":
            e, _ = ref.MS_decoder(H, syn[s], p / 3, max_iter=iters,
                                  layers=layers, OSDorder=osd_order)
        elif dec_type == "BP":
            e, _ = ref.BP_decoder(H, syn[s], p / 3, max_iter=iters,
                                  layers=layers, OSDorder=osd_order)
        elif dec_type == "BF":
            e, _ = ref.BF_decoder(H, syn[s])
        elif dec_type == "NG":
            e, _ = ref.NG_decoder(H, syn[s])
        else:
            raise ValueError(dec_type)
        es[s] = np.asarray(e).astype(np.int64) % 2
    return es


def _decode_side_batch(H, syn, p, dec_type, iters, layers, osd_order,
                       bf_residual):
    """Decode all shots of one side, preferring the native C++ oracle."""
    import oracle
    from qldpcsim_jax.gf2.native import (bp_decode_native, ms_decode_native,
                                         osd_decode_native)

    B = syn.shape[0]
    if dec_type in ("MS", "BP"):
        native = ms_decode_native if dec_type == "MS" else bp_decode_native
        out = native(H, syn, p / 3, iters, layers)
        if out is not None:
            e, _it, conv, post = out
            if osd_order < 0:
                return e
            fails = np.nonzero(~conv)[0]
            if fails.size == 0:
                return e
            eo = osd_decode_native(H, e[fails], syn[fails],
                                   post[fails].astype(np.float64), osd_order)
            if eo is not None:
                e = e.copy()
                e[fails] = eo
                return e
    # per-shot NumPy fallback / BF / NG
    es = np.zeros((B, H.shape[1]), np.int8)
    for s in range(B):
        if dec_type == "MS":
            e, it, post, conv = oracle.ms_decode(H, syn[s], p / 3, iters, layers)
            if osd_order >= 0 and not conv:
                e = oracle.osd_decode(H, e, syn[s], post, osd_order)
        elif dec_type == "BP":
            e, it, post, conv = oracle.bp_decode_strict(H, syn[s], p / 3,
                                                        iters, layers)
            if osd_order >= 0 and not conv:
                e = oracle.osd_decode(H, e, syn[s], post, osd_order)
        elif dec_type == "BF":
            e = oracle.bf_decode(H, syn[s], residual=bf_residual)[0]
        elif dec_type == "NG":
            e = oracle.ng_decode(H, syn[s])[0]
        else:
            raise ValueError(dec_type)
        es[s] = np.asarray(e, np.int8) % 2
    return es


def oracle_qbler(code, p, shots, dec_type, iters, schedule, osd_order, seed,
                 bf_residual="mod2", oracle_mode="native"):
    """Reference-semantics pipeline on the CPU oracle decoders."""
    from qldpcsim_jax.decoders import layerize

    Hx, Hz, err_x, err_z, sy_z, sy_x = _sample_channel(code, p, shots, seed)
    serial = schedule == "S"
    if schedule == "F":
        layers_x = [np.arange(Hz.shape[0])]
        layers_z = [np.arange(Hx.shape[0])]
    else:
        layers_x = layerize(Hz, serial=serial)
        layers_z = layerize(Hx, serial=serial)

    if oracle_mode == "reference":
        ex = _decode_side_batch_reference(Hz, sy_z, p, dec_type, iters,
                                          layers_x, osd_order)
        ez = _decode_side_batch_reference(Hx, sy_x, p, dec_type, iters,
                                          layers_z, osd_order)
    else:
        ex = _decode_side_batch(Hz, sy_z, p, dec_type, iters, layers_x,
                                osd_order, bf_residual)
        ez = _decode_side_batch(Hx, sy_x, p, dec_type, iters, layers_z,
                                osd_order, bf_residual)

    # reference event classification (simulator.py:291-303), vectorized
    rx = err_x.astype(np.int64) ^ (ex.astype(np.int64) % 2)
    rz = err_z.astype(np.int64) ^ (ez.astype(np.int64) % 2)
    exact = (rx == 0).all(axis=1) & (rz == 0).all(axis=1)
    degen = (~exact) \
        & (Hz.astype(np.int64) @ rx.T == 0).all(axis=0) \
        & (Hx.astype(np.int64) @ rz.T == 0).all(axis=0)
    good = int((exact | degen).sum())
    return 1.0 - good / shots


def engine_qbler(code, p, shots, dec_type, iters, schedule, osd_order, seed,
                 bf_residual="mod2"):
    from qldpcsim_jax.engine.montecarlo import SimConfig, simulate_p

    cfg = SimConfig(shots=shots, dec_type=dec_type, dec_iterations=iters,
                    dec_schedule=schedule, osd_order=osd_order, rng_seed=seed,
                    bf_residual=bf_residual)
    r = simulate_p(code.Hx, code.Hz, p, cfg)
    return r.qbler, r.shots_per_s


def run_one(name, code_name, p, n_new, n_ref, dec_type, iters, schedule,
            osd_order=-1, seed=0, bf_residual="mod2", oracle_mode="native"):
    from qldpcsim_jax.codes import get_code

    if oracle_mode == "reference" and dec_type == "BF":
        # the literal reference BF is the bool-residual decoder
        # (decoders.py:93-95) — apples-to-apples requires it engine-side
        bf_residual = "bool"
    code = get_code(code_name)
    q_new, sps = engine_qbler(code, p, n_new, dec_type, iters, schedule,
                              osd_order, seed, bf_residual)
    t0 = time.time()
    q_ref = oracle_qbler(code, p, n_ref, dec_type, iters, schedule,
                         osd_order, seed, bf_residual, oracle_mode)
    ref_sps = n_ref / max(time.time() - t0, 1e-9)
    pool = (q_new * n_new + q_ref * n_ref) / (n_new + n_ref)
    var = max(pool * (1 - pool), 1.0 / (n_new + n_ref))
    bound = Z * math.sqrt(var * (1.0 / n_new + 1.0 / n_ref))
    return {
        "config": name, "code": code_name, "decoder": dec_type,
        "schedule": schedule, "osd": osd_order, "p": p,
        "oracle": ("reference-import" if oracle_mode == "reference"
                   else "native"),
        "qBLER_new": round(q_new, 5), "shots_new": n_new,
        "qBLER_ref": round(q_ref, 5), "shots_ref": n_ref,
        "bound": round(bound, 5),
        "pass": bool(abs(q_new - q_ref) <= bound),
        "engine_shots_per_s": round(sps, 1),
        "oracle_shots_per_s": round(ref_sps, 2),
        **({"bf_residual": bf_residual} if dec_type == "BF" else {}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale factor on oracle shot counts")
    ap.add_argument("--oracle", choices=["native", "reference"],
                    default="native",
                    help="oracle side: native C++/NumPy reference-semantics "
                         "decoders (fast) or the literal path-imported "
                         "reference (slow; reduced shot counts)")
    ap.add_argument("--only", default=None,
                    help="comma-separated config-name prefixes to run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    def s(x):
        return max(64, int(x * args.scale))

    mode = args.oracle

    def S(native_count, ref_count):
        """Oracle shots: full-speed native count or reduced literal count."""
        return s(ref_count if mode == "reference" else native_count)

    rows = []
    # BASELINE.json configs 1-5. Oracle counts sized so every 4-sigma bound
    # lands <= 0.02 at full scale in native mode (worst case bicycle BF,
    # qBLER~0.4); reference-import counts sized for ~30 min total wall time
    # (measured: tanner MS serial 1.6 s/shot, lp118 BP+OSD 0.2 s/shot).
    kw = {"oracle_mode": mode}
    prefixes = (tuple(x.strip() for x in args.only.split(","))
                if args.only else None)

    def R(name, *a, **k):
        if prefixes and not name.startswith(prefixes):
            return None
        return run_one(name, *a, **k)

    rows.append(R("1_shor_bp_p01", "shor", 0.01, 100000, S(20000, 20000), "BP", 99, "F", **kw))
    rows.append(R("1_shor_bp_p05", "shor", 0.05, 100000, S(20000, 20000), "BP", 99, "F", **kw))
    rows.append(R("2_steane_nms_layered", "steane", 0.05, 100000, S(20000, 20000), "MS", 50, "L", **kw))
    rows.append(R("3_bicycle_bf", "bicycle", 0.02, 100000, S(20000, 20000), "BF", 50, "F", **kw))
    rows.append(R("3_bicycle_bf_refres", "bicycle", 0.02, 100000, S(20000, 20000), "BF", 50, "F",
                  bf_residual="bool", **kw))
    rows.append(R("3_bicycle_ng", "bicycle", 0.01, 100000, S(20000, 8000), "NG", 0, "F", **kw))
    rows.append(R("4_tanner_ms_serial", "tanner", 0.04, 65536, S(10000, 400), "MS", 30, "S", **kw))
    rows.append(R("5_lp04_bp_osd2", "lp04_0", 0.04, 100000, S(20000, 4000), "BP", 30, "F", osd_order=2, **kw))
    rows.append(R("5_lp118_bp_osd2", "lp118_0", 0.05, 100000, S(10000, 2000), "BP", 30, "F", osd_order=2, **kw))
    # the reference's own OSD wiring is MS-only (landmine L5) — cover it too
    rows.append(R("5b_lp118_ms_osd2", "lp118_0", 0.05, 100000, S(10000, 4000), "MS", 30, "F", osd_order=2, **kw))
    rows = [r for r in rows if r is not None]

    out = "\n".join(json.dumps(r) for r in rows)
    print(out)
    n_fail = sum(not r["pass"] for r in rows)
    maxb = max(r["bound"] for r in rows)
    print(f"# parity: {len(rows) - n_fail}/{len(rows)} within {Z}-sigma; "
          f"max bound {maxb:.4f}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
