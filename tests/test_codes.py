"""Code-library tests: constructors reproduce the reference data assets
byte-for-byte and satisfy CSS orthogonality (SURVEY.md §4.1)."""

import os

import numpy as np
import pytest

from qldpcsim_jax import gf2
from qldpcsim_jax.codes import (
    CODE_REGISTRY,
    code_from_files,
    get_code,
    load_matrix,
)

REF_DATA = "/root/reference/data"

# Registry name -> reference .npy stem (SURVEY.md §2.5).
_REF_FILES = {
    "shor": "shor",
    "steane": "steane",
    "tanner": "T",
    "lp04_0": "LP04_0",
    "lp04_1": "LP04_1",
    "lp04_2": "LP04_2",
    "lp04_3": "LP04_3",
    "lp118_0": "LP118_0",
    "lp118_1": "LP118_1",
    "lp118_2": "LP118_2",
}


@pytest.mark.parametrize("name", sorted(CODE_REGISTRY))
def test_css_orthogonality(name):
    code = get_code(name)
    assert gf2.check_css(code.Hx, code.Hz), f"{name}: Hx @ Hz.T != 0 mod 2"


@pytest.mark.parametrize("name,stem", sorted(_REF_FILES.items()))
@pytest.mark.skipif(not os.path.isdir(REF_DATA), reason="reference data not mounted")
def test_constructors_match_reference_assets(name, stem):
    code = get_code(name)
    Hx_ref = (np.load(f"{REF_DATA}/Hx_{stem}.npy") % 2).astype(np.int8)
    Hz_ref = (np.load(f"{REF_DATA}/Hz_{stem}.npy") % 2).astype(np.int8)
    assert (code.Hx == Hx_ref).all(), f"{name}: Hx mismatch vs reference asset"
    assert (code.Hz == Hz_ref).all(), f"{name}: Hz mismatch vs reference asset"


def test_expected_shapes():
    shapes = {
        "shor": ((2, 9), (6, 9)),
        "steane": ((3, 7), (3, 7)),
        "bicycle": ((73, 146), (73, 146)),
        "tanner": ((465, 1054), (465, 1054)),
        "lp118_0": ((240, 544), (240, 544)),
        "lp118_2": ((450, 1020), (450, 1020)),
    }
    for name, (sx, sz) in shapes.items():
        code = get_code(name)
        assert code.Hx.shape == sx and code.Hz.shape == sz


def test_bicycle_selfdual_and_rowweight():
    code = get_code("bicycle")
    assert (code.Hx == code.Hz).all()
    assert (code.Hx.sum(axis=1) == 18).all()  # two difference-set circulants


def test_load_matrix_text_and_npy(tmp_path):
    A = np.array([[1, 0, 1], [0, 1, 1]], dtype=np.int64)
    npy = tmp_path / "a.npy"
    np.save(npy, A * 3)  # loader must reduce mod 2
    assert (load_matrix(str(npy)) == A).all()
    txt = tmp_path / "a.txt"
    txt.write_text("1 0 1\n\n0 1 1\n")
    assert (load_matrix(str(txt)) == A).all()
    code = code_from_files(str(npy), str(txt))
    assert (code.Hx == code.Hz).all()


def test_unknown_code_raises():
    with pytest.raises(KeyError):
        get_code("nope")
    with pytest.raises(ValueError):
        from qldpcsim_jax.codes import qc_ldpc_lifted_code

        qc_ldpc_lifted_code("LP04", 4)
