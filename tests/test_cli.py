"""CLI and data-asset tests (reference CLI surface: simulator.py:351-374)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(args, timeout=300):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "qldpcsim_jax", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)


def test_cli_end_to_end(tmp_path):
    out = tmp_path / "res.jsonl"
    r = _run_cli(["--code", "shor", "--p", "0.02", "--shots", "200",
                  "--decType", "MS", "--decIterations", "8", "--quiet",
                  "--rngSeed", "3", "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SIMULATION RESULTS" in r.stdout
    row = json.loads(out.read_text().splitlines()[0])
    assert row["shots"] == 200
    assert 0.0 <= row["qBLER"] <= 1.0


def test_cli_matrix_files(tmp_path):
    r = _run_cli(["--Hx", "data/Hx_steane.npy", "--Hz", "data/Hz_steane.npy",
                  "--p", "0.01", "--shots", "100", "--decType", "BF",
                  "--quiet"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SIMULATION RESULTS" in r.stdout


def test_cli_arg_errors():
    assert _run_cli(["--p", "0.1"], timeout=60).returncode == 2
    assert _run_cli(["--code", "shor", "--p", "1.5"], timeout=60).returncode == 2
    assert _run_cli(["--code", "shor", "--p", "0.1", "--decType", "XX"],
                    timeout=60).returncode == 2


def test_data_assets_match_reference():
    ref = "/root/reference/data"
    if not os.path.isdir(ref):
        pytest.skip("reference data not mounted")
    for stem in os.listdir(os.path.join(REPO, "data")):
        refpath = os.path.join(ref, stem)
        if not os.path.exists(refpath):      # bicycle is a bonus asset
            continue
        a = np.load(refpath) % 2
        b = np.load(os.path.join(REPO, "data", stem)) % 2
        assert a.shape == b.shape and (a == b).all(), stem


def test_device_choice():
    """device="cpu" is an explicit choice of the CPU backend; "auto" keeps
    the session default for every code size, and nothing else is accepted
    (no code is routed off its device on its own)."""
    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.engine.montecarlo import ShotPipeline, SimConfig

    code = get_code("shor")
    pipe = ShotPipeline(code.Hx, code.Hz,
                        SimConfig(shots=64, batch_size=64, device="cpu"))
    assert pipe.exec_device is not None
    assert pipe.exec_device.platform == "cpu"

    assert pipe.dcfg.platform == "cpu"

    pipe2 = ShotPipeline(code.Hx, code.Hz,
                         SimConfig(shots=64, batch_size=64, device="auto"))
    assert pipe2.exec_device is None
    with pytest.raises(ValueError, match="device"):
        ShotPipeline(code.Hx, code.Hz,
                     SimConfig(shots=64, batch_size=64, device="default"))
