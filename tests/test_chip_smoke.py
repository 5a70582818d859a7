"""chip_smoke.py on the CPU: its refusal to run without a GPU, and each phase
function at tiny sizes with the CPU standing in for the card (the
four-card phase on four virtual CPU devices)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = dict(code="steane", dec_type="MS", dec_iterations=10,
            dec_schedule="L", p=0.05, batch_size=256)


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def _has_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_refuses_without_gpu():
    r = _run(REPO)
    assert r.returncode != 0
    assert not _has_result(r.stdout)
    assert "no GPU" in r.stderr


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert not _has_result(r.stdout)


def test_phase_channel():
    cpu = jax.devices("cpu")[0]
    r = chip_smoke.phase_channel(cpu, cpu, n_tiles=2, tile=32)
    assert r["ok"] and r["shots"] == 64 and all(r["bit_exact"].values())


def test_phase_decoder():
    """Off the card the Triton kernel is skipped and the XLA path agrees
    with edge."""
    cpu = jax.devices("cpu")[0]
    r = chip_smoke.phase_decoder(cpu, codes=("lp118_0",), B=128, max_iter=12)
    assert r["ok"], r
    assert [row["impl"] for row in r["rows"]] == ["mxu"]
    assert all(row["syndrome_consistency"] == 1.0 for row in r["rows"])


def test_phase_flagship():
    r = chip_smoke.phase_flagship(shots=1024, cpu_shots=512, flagship=TINY)
    assert r["ok"], r
    assert r["compile_s"] > 0 and r["memory_analysis"]


def test_phase_baselines():
    specs = [("steane_ms", "steane", [0.03], 512, 256, "MS", 10, "L", -1),
             ("bicycle_bf", "bicycle", [0.01], 256, 256, "BF", 10, "F", -1)]
    r = chip_smoke.phase_baselines(specs=specs)
    assert r["ok"], r
    assert len(r["rows"]) == 2
    assert r["rows"][1]["counters_equal"]   # same shots, same backend


def test_phase_timing():
    r = chip_smoke.phase_timing(impls=("mxu", "edge"), B=64, e2e_shots=1024,
                                dispatch_chunks=1, reps=1, flagship=TINY)
    assert r["ok"], r
    assert [row["impl"] for row in r["rows"]] == ["mxu", "edge"]


def test_phase_four_cards(eight_devices):
    """The four-card path on four virtual CPU devices: the mesh run and both
    p-sharded sweeps reproduce the 1-device counters bit-exactly."""
    r = chip_smoke.phase_four_cards(jax.devices()[:4], shots=2048,
                                    sweep_shots=1024, ps=(0.03, 0.06),
                                    flagship=TINY)
    assert r["ok"], r
    assert {row["path"] for row in r["rows"]} == {
        "simulate_p mesh=4", "simulate_sweep mesh_p=2",
        "simulate_sweep mesh_p=4"}


@pytest.mark.parametrize("qa,qb,ok", [(0.05, 0.05, True), (0.05, 0.2, False)])
def test_qbler_bound(qa, qb, ok):
    from types import SimpleNamespace

    def res(q, n=4096):
        return SimpleNamespace(qbler=q, shots=n)

    diff, bound = chip_smoke._qbler_bound(res(qa), res(qb))
    assert (diff <= bound) is ok
