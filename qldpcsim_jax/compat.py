"""Reference-compatible API shims (drop-in surface for qLDPCsim users).

A user of the reference package can switch imports and keep their code:

    from qLDPCsim import decoders, PCMlibrary, gf2math, simulator
        -> from qldpcsim_jax.compat import decoders, PCMlibrary, gf2math, simulator

Signatures, argument names, defaults and return conventions mirror the
reference (citations inline); computation is this framework's batched
device path with batch size 1 for the per-shot decoder calls. Notes:

  * NG/BF/MS/BP return (e_hat, n_iter) like the reference
    (decoders.py:66,102,182,290); `layers` accepts the reference's list of
    row-index arrays (simulator.py:212-236 layerize output).
  * BF_decoder uses the reference's any-overlap "bool" residual
    (decoders.py:93-95) so it is shot-for-shot drop-in — unlike the engine,
    whose default is the standard mod-2 parity residual
    (DecoderConfig.bf_residual, DIVERGENCES.md "BF residual").
  * OSDdec never mutates its arguments and enumerates all 2^order patterns
    (the reference's aliasing landmine L4 is deliberately not reproduced —
    DIVERGENCES.md).
  * simulator.build_stim_circuit does not exist here by design: the Stim
    circuit layer is replaced by the native GF(2) channel
    (qldpcsim_jax.channel); calling it raises with that explanation.
  * gf2math.REF returns (B, T) with B = (T @ A) % 2 like the reference
    (gf2math.py:139-187).
"""

from __future__ import annotations

import sys
import types

import numpy as np


# --------------------------------------------------------------------------
# gf2math (reference: qLDPCsim/gf2math.py)
# --------------------------------------------------------------------------

def _gf2math_module():
    from qldpcsim_jax import gf2

    mod = types.ModuleType("qldpcsim_jax.compat.gf2math")

    def rank(A):
        return gf2.rank(np.asarray(A))

    def REF(A, reduced=False):
        B, T, _ = gf2.ref(np.asarray(A), reduced=reduced)
        return B, T

    def nullSpace(A):
        return gf2.null_space(np.asarray(A))

    def rowBasis(M):
        return gf2.row_basis(np.asarray(M))

    def systematic_form(H):
        return gf2.systematic_form(np.asarray(H))

    mod.rank, mod.REF, mod.nullSpace = rank, REF, nullSpace
    mod.rowBasis, mod.systematic_form = rowBasis, systematic_form
    return mod


# --------------------------------------------------------------------------
# PCMlibrary (reference: qLDPCsim/PCMlibrary.py; the reference's __init__
# exports the misspelled name `PMClibrary` — both spellings work here)
# --------------------------------------------------------------------------

def _pcm_module():
    from qldpcsim_jax.codes import (
        bicycle_code,
        qc_ldpc_lifted_code,
        qc_ldpc_tanner_code,
        shor_code,
        steane_code,
    )

    mod = types.ModuleType("qldpcsim_jax.compat.PCMlibrary")
    mod.shor_code = shor_code
    mod.steane_code = steane_code
    mod.bicycle_code = bicycle_code
    mod.qc_ldpc_tanner_code = qc_ldpc_tanner_code
    mod.qc_ldpc_lifted_code = qc_ldpc_lifted_code
    return mod


# --------------------------------------------------------------------------
# decoders (reference: qLDPCsim/decoders.py) — per-shot signatures
# --------------------------------------------------------------------------

def _decoders_module():
    from qldpcsim_jax.decoders import (
        DecoderConfig,
        LayerSchedule,
        TannerGraph,
        layerize,
        make_decoder,
        make_osd,
    )

    mod = types.ModuleType("qldpcsim_jax.compat.decoders")
    mod.layerize = layerize

    def _layers_sched(H, layers):
        if layers is None:
            return None
        m = np.asarray(H).shape[0]
        return LayerSchedule.from_layers([np.asarray(l) for l in layers], m)

    def _run(dec_type, H, syndrome, p=0.01, max_iter=99, layers=None,
             beta=0.75, OSDorder=-1, eps=1e-9, bf_max_iter=50,
             bf_residual="bool"):
        H = np.asarray(H) % 2
        graph = TannerGraph.build(H)
        cfg = DecoderConfig(dec_type=dec_type, max_iter=max_iter,
                            schedule="F", beta=beta,
                            eps=max(eps, 1e-6), bf_max_iter=bf_max_iter,
                            bf_residual=bf_residual, osd_order=-1)
        dec = make_decoder(graph, cfg, layers=_layers_sched(H, layers))
        syn = np.asarray(syndrome).reshape(1, -1)
        r = dec(syn, p)
        e = np.asarray(r.e_hat)[0]
        n_it = int(np.asarray(r.n_iter)[0])
        if OSDorder >= 0 and not bool(np.asarray(r.converged)[0]):
            osd = make_osd(H, OSDorder)
            post = np.asarray(r.posterior)[:1]
            e = np.asarray(osd(e.reshape(1, -1), syn, post))[0]
        return e, n_it

    def NG_decoder(H, syndrome):
        # reference decoders.py:27-66
        return _run("NG", H, syndrome)

    def BF_decoder(H, syndrome, max_iter=50):
        # reference decoders.py:74-102. Drop-in means reference-exact: the
        # shim defaults to the reference's any-overlap "bool" residual
        # (decoders.py:93-95), unlike the engine's mod2 default — the two
        # are measurably different decoders (DIVERGENCES.md "BF residual").
        return _run("BF", H, syndrome, bf_max_iter=max_iter,
                    bf_residual="bool")

    def MS_decoder(H, syndrome, p, max_iter=99, layers=None, beta=0.75,
                   OSDorder=-1, eps=1e-9):
        # reference decoders.py:110-182
        return _run("MS", H, syndrome, p=p, max_iter=max_iter, layers=layers,
                    beta=beta, OSDorder=OSDorder, eps=eps)

    def BP_decoder(H, syndrome, p, max_iter=99, layers=None, OSDorder=-1,
                   eps=1e-9):
        # reference decoders.py:189-290
        return _run("BP", H, syndrome, p=p, max_iter=max_iter, layers=layers,
                    OSDorder=OSDorder, eps=eps)

    def OSDdec(H, e_hat, syndrome, posteriorLLRs, order):
        # reference decoders.py:299-369 (no L4 aliasing; inputs not mutated)
        H = np.asarray(H) % 2
        osd = make_osd(H, int(order))
        e = np.asarray(osd(np.asarray(e_hat).reshape(1, -1),
                           np.asarray(syndrome).reshape(1, -1),
                           np.asarray(posteriorLLRs, np.float32).reshape(1, -1)))
        return e[0]

    mod.NG_decoder, mod.BF_decoder = NG_decoder, BF_decoder
    mod.MS_decoder, mod.BP_decoder, mod.OSDdec = MS_decoder, BP_decoder, OSDdec
    return mod


# --------------------------------------------------------------------------
# simulator (reference: qLDPCsim/simulator.py)
# --------------------------------------------------------------------------

def _simulator_module():
    from qldpcsim_jax.codes.loader import load_matrix
    from qldpcsim_jax.engine.montecarlo import SimConfig
    from qldpcsim_jax.engine.montecarlo import simulate as _simulate
    from qldpcsim_jax.engine.montecarlo import simulate_p as _simulate_p
    from qldpcsim_jax.cli import main as _main

    mod = types.ModuleType("qldpcsim_jax.compat.simulator")
    mod.load_matrix = load_matrix
    mod.main = _main

    def simulate(HxFile, HzFile, p, shots=1000, decType="MS",
                 decIterations=99, decSchedule="F", OSDorder=-1,
                 rngSeed=None):
        # reference simulator.py:319-347 (same signature; returns the
        # per-p results list instead of None)
        return _simulate(HxFile, HzFile, p, shots=shots, decType=decType,
                         decIterations=decIterations, decSchedule=decSchedule,
                         OSDorder=OSDorder, rngSeed=rngSeed)

    def simulate_p(Hx, Hz, p, shots=1000, decType="MS", decIterations=99,
                   decSchedule="F", OSDorder=-1, rngSeed=None):
        # reference simulator.py:167-315 — returns the reference's counters
        # dict (simulator.py:308-315)
        cfg = SimConfig(shots=shots, dec_type=decType,
                        dec_iterations=decIterations,
                        dec_schedule=decSchedule, osd_order=OSDorder,
                        rng_seed=rngSeed)
        r = _simulate_p(np.asarray(Hx), np.asarray(Hz), float(p), cfg)
        return {
            "DecFailures_X": r.counters["DecFailures_X"],
            "DecFailures_Z": r.counters["DecFailures_Z"],
            "decSuccessExact": r.counters["decSuccessExact"],
            "decSuccessDegen": r.counters["decSuccessDegen"],
            "Avg_number_of_iterations_X": r.avg_iterations_x,
            "Avg_number_of_iterations_Z": r.avg_iterations_z,
        }

    def build_stim_circuit(*a, **k):
        raise NotImplementedError(
            "build_stim_circuit is intentionally absent: the Stim circuit "
            "layer is replaced by the native GF(2) channel "
            "(qldpcsim_jax.channel) — see README 'Design' and SURVEY.md §7.")

    mod.simulate, mod.simulate_p = simulate, simulate_p
    mod.build_stim_circuit = build_stim_circuit
    return mod


gf2math = _gf2math_module()
PCMlibrary = _pcm_module()
PMClibrary = PCMlibrary  # the reference __init__'s typo, kept working
decoders = _decoders_module()
simulator = _simulator_module()

# Register as importable submodules: `from qldpcsim_jax.compat import X` and
# `import qldpcsim_jax.compat.X` both work.
for _name, _mod in (("gf2math", gf2math), ("PCMlibrary", PCMlibrary),
                    ("PMClibrary", PMClibrary), ("decoders", decoders),
                    ("simulator", simulator)):
    sys.modules[f"{__name__}.{_name}"] = _mod

__all__ = ["gf2math", "PCMlibrary", "PMClibrary", "decoders", "simulator"]
