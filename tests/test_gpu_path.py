"""What the traced main-path programs contain: no Pallas kernel, and no
f32 contraction that a GPU may run in TF32 (each carries HIGHEST
precision; the exact +-1 bf16 Hamming product is the one non-f32 case)."""

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

from lvt_tpu.config import VOConfig
from lvt_tpu.core import step
from lvt_tpu.core.state import VOState
from lvt_tpu.parallel import multistream as ms

H, W = 64, 96


def _config(**kw):
    return VOConfig(fx=80.0, fy=80.0, cx=48.0, cy=32.0, baseline=0.2,
                    img_width=W, img_height=H, detection_cell_size=48,
                    max_keypoints_per_cell=32, max_map_points=128,
                    max_staged_points=128, **kw)


def _stereo_ba():
    cfg = _config(local_ba_window=4, hamming_matmul=True)
    img = jnp.zeros((H, W), jnp.uint8)
    return jax.make_jaxpr(lambda s, a, b: step.track_step_stereo(
        s, a, b, cfg))(VOState.initial(128, 128, 4), img, img)


def _rgbd():
    cfg = _config(k1=0.2, k2=-0.1)
    return jax.make_jaxpr(lambda s, a, b: step.track_step_rgbd(
        s, a, b, cfg))(VOState.initial(128, 128),
                       jnp.zeros((H, W), jnp.uint8),
                       jnp.zeros((H, W), jnp.float32))


def _multistream_chunk():
    cfg = _config()
    imgs = jnp.zeros((2, 3, H, W), jnp.uint8)
    return jax.make_jaxpr(lambda s, a, b: ms.multistream_chunk(
        s, a, b, cfg))(ms.batched_initial_state(cfg, 3), imgs, imgs)


PROGRAMS = {"stereo_ba4": _stereo_ba, "rgbd": _rgbd,
            "multistream_chunk": _multistream_chunk}


def _eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for param in eqn.params.values():
            for sub in param if isinstance(param, (list, tuple)) else [param]:
                if isinstance(sub, jcore.ClosedJaxpr):
                    yield from _eqns(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    yield from _eqns(sub)


@pytest.fixture(scope="module")
def traced():
    return {name: list(_eqns(fn().jaxpr)) for name, fn in PROGRAMS.items()}


@pytest.mark.parametrize("name", PROGRAMS)
def test_no_pallas_call(traced, name):
    prims = {e.primitive.name for e in traced[name]}
    assert "dot_general" in prims
    assert not any("pallas" in p for p in prims), sorted(prims)


@pytest.mark.parametrize("name", PROGRAMS)
def test_f32_contractions_are_highest_precision(traced, name):
    dots = [e for e in traced[name] if e.primitive.name == "dot_general"]
    f32 = [e for e in dots
           if any(v.aval.dtype == jnp.float32 for v in e.invars)]
    assert f32
    loose = [str(e.source_info.traceback).splitlines()[-1:] for e in f32
             if e.params["precision"] is None
             or any(p != jax.lax.Precision.HIGHEST
                    for p in e.params["precision"])]
    assert not loose, loose
