"""The execution-platform decision (qldpcsim_jax/platform.py), the decode
kernel it picks, the compile-cache path rule and the precision pins."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qldpcsim_jax.codes import get_code
from qldpcsim_jax.decoders import DecoderConfig, TannerGraph, build_layers, make_decoder
from qldpcsim_jax.platform import platform_of, qc_kernel_applies, resolve_platform


def _devs(*plats):
    return [types.SimpleNamespace(platform=p) for p in plats]


@pytest.mark.parametrize("plats,want", [
    (("gpu",), "gpu"),
    (("gpu", "gpu", "gpu", "gpu"), "gpu"),
    (("cpu",), "cpu"),
    (("rocm",), None),         # refused, not guessed
    (("metal",), None),
    (("gpu", "cpu"), None),    # a pipeline runs on one platform
])
def test_platform_of(plats, want):
    if want is None:
        with pytest.raises(ValueError):
            platform_of(_devs(*plats))
    else:
        assert platform_of(_devs(*plats)) == want


def test_resolve_platform():
    assert resolve_platform("gpu") == "gpu"     # explicit values stand
    assert resolve_platform("cpu", _devs("gpu")) == "cpu"
    assert resolve_platform("auto", _devs("gpu")) == "gpu"
    assert resolve_platform("auto") == jax.devices()[0].platform == "cpu"
    with pytest.raises(ValueError, match="platform"):
        resolve_platform("rocm")


@pytest.mark.parametrize("platform,impl,supported,want", [
    ("gpu", "auto", True, True),
    ("gpu", "auto", False, False),
    ("cpu", "auto", True, False),
    ("gpu", "mxu", True, False),
    ("gpu", "edge", True, False),
    ("gpu", "qc", True, True),
    ("gpu", "qc", False, "raise"),   # forced but structurally impossible
    ("cpu", "qc", True, "raise"),    # no CPU path for a card kernel
])
def test_qc_kernel_applies(platform, impl, supported, want):
    if want == "raise":
        with pytest.raises(ValueError):
            qc_kernel_applies(platform, impl, supported)
    else:
        assert qc_kernel_applies(platform, impl, supported) is want


@pytest.mark.parametrize("platform,impl,dec,want", [
    ("gpu", "auto", "MS", True),    # the flagship on the card
    ("cpu", "auto", "MS", False),
    ("gpu", "mxu", "MS", False),
    ("gpu", "auto", "BP", False),
])
def test_make_decoder_kernel_choice(monkeypatch, platform, impl, dec, want):
    """make_decoder builds the Triton decoder exactly when the platform
    decision picks it (building traces nothing, so it runs here)."""
    from qldpcsim_jax.ops import ms_qc_triton

    built = []
    orig = ms_qc_triton.make_ms_qc_decoder

    def spy(*a, **k):
        built.append(a)
        return orig(*a, **k)

    monkeypatch.setattr(ms_qc_triton, "make_ms_qc_decoder", spy)
    H = np.asarray(get_code("lp118_0").Hz)
    cfg = DecoderConfig(dec_type=dec, max_iter=50, schedule="L", impl=impl,
                        platform=platform)
    make_decoder(TannerGraph.build(H), cfg, layers=build_layers(H, "L"))
    assert bool(built) == want


def test_make_decoder_refuses_qc_off_card():
    H = np.asarray(get_code("lp118_0").Hz)
    cfg = DecoderConfig(dec_type="MS", schedule="L", impl="qc",
                        platform="cpu")
    with pytest.raises(ValueError, match="GPU"):
        make_decoder(TannerGraph.build(H), cfg)


def test_pipeline_platform_from_devices():
    """ShotPipeline resolves its platform from the devices it runs on and
    records it in the decoder config that keys checkpoints."""
    from qldpcsim_jax.engine.montecarlo import ShotPipeline, SimConfig

    code = get_code("steane")
    pipe = ShotPipeline(code.Hx, code.Hz, SimConfig(shots=64, batch_size=64))
    assert pipe.dcfg.platform == "cpu"


def test_cache_dir_rule():
    from qldpcsim_jax.utils import jaxcache

    checkout = jaxcache.DEFAULT_CACHE_DIR.parent
    assert (checkout / "qldpcsim_jax").is_dir()
    assert jaxcache.DEFAULT_CACHE_DIR.name == ".jax_cache"
    with open(checkout / ".gitignore") as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("env", [None, "/some/where/else"])
def test_enable_compilation_cache(monkeypatch, env):
    """Unset: the checkout's .jax_cache. Set: JAX reads the variable itself
    and nothing is overridden."""
    from qldpcsim_jax.utils import jaxcache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(jaxcache, "_DONE", False)
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    try:
        jax.config.update("jax_compilation_cache_dir", "sentinel")
        jaxcache.enable_compilation_cache()
        got = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert got == (str(jaxcache.DEFAULT_CACHE_DIR) if env is None
                   else "sentinel")


def _dots(jaxpr):
    """Every dot_general equation, nested jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dots(sub)


@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_mxu_posterior_dots_pinned_highest(kind):
    """The real-valued LLR dots of the incidence-matmul decoders run at
    HIGHEST precision (no TF32 rounding on a GPU); only the exact 0/1
    syndrome check runs in bf16."""
    from qldpcsim_jax.decoders.bp_mxu import make_bp_mxu_decoder
    from qldpcsim_jax.decoders.ms_mxu import make_ms_mxu_decoder

    H = np.asarray(get_code("lp04_0").Hz)
    make = make_ms_mxu_decoder if kind == "MS" else make_bp_mxu_decoder
    cfg = DecoderConfig(dec_type=kind, max_iter=4, schedule="L")
    dec = make(TannerGraph.build(H), cfg, layers=build_layers(H, "L"))
    jaxpr = jax.make_jaxpr(dec)(jnp.zeros((8, H.shape[0]), jnp.int8),
                                jnp.float32(0.01)).jaxpr
    f32_dots = [e for e in _dots(jaxpr)
                if e.invars[0].aval.dtype == jnp.float32]
    assert len(f32_dots) >= 2
    hi = jax.lax.Precision.HIGHEST
    for e in f32_dots:
        assert e.params["precision"] == (hi, hi), e


def test_deferred_posterior_extraction_pinned_highest():
    """The one-hot extraction of deferred OSD posteriors is exact: HIGHEST."""
    from qldpcsim_jax.engine.montecarlo import ShotPipeline, SimConfig

    code = get_code("steane")
    pipe = ShotPipeline(code.Hx, code.Hz,
                        SimConfig(shots=64, batch_size=64, dec_type="BP",
                                  dec_iterations=4, osd_order=1))
    keys = jnp.zeros((pipe.tiles_per_chunk, 2), jnp.uint32)
    jaxpr = jax.make_jaxpr(pipe._chunk_body_defer)(
        keys, jnp.float32(0.05), jnp.int32(64)).jaxpr
    hi = jax.lax.Precision.HIGHEST
    assert any(e.params["precision"] == (hi, hi) for e in _dots(jaxpr))
