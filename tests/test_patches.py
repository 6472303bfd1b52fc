"""Patch descriptor mode (ops/patches).

Two equivalence layers:
  1. patch-based descriptors/subpixel against the established sparse/
     scatter lowerings (bit-identical at valid keypoints);
  2. the full extraction pipeline in "patch" mode against "dense" mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lvt_tpu.config import VOConfig
from lvt_tpu.core import extract
from lvt_tpu.ops import brief, detect
from lvt_tpu.ops import patches as pt


@pytest.fixture
def rng():
    return np.random.RandomState(7)


def test_descriptors_from_patches_match_sparse(rng):
    h, w = 128, 192
    smooth = jnp.asarray(rng.rand(h, w).astype(np.float32) * 20000.0)
    k = 64
    x = rng.randint(0, w, k).astype(np.int32)
    y = rng.randint(0, h, k).astype(np.int32)
    valid_in = rng.rand(k) > 0.2
    kp = jnp.stack([jnp.asarray(x, jnp.float32),
                    jnp.asarray(y, jnp.float32)], axis=-1)
    d_sparse, v_sparse = brief.descriptors_sparse(
        smooth, kp, jnp.asarray(valid_in))

    xc, yc = pt.clamp_coords(jnp.asarray(x), jnp.asarray(y), h, w)
    patches, _ = pt.extract_patches_xla(
        smooth[None], smooth[None], xc[None], yc[None],
        jnp.ones((1, k), bool))
    d_patch, v_patch = brief.descriptors_from_patches(
        patches[0], jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid_in),
        h, w)
    np.testing.assert_array_equal(np.asarray(v_patch), np.asarray(v_sparse))
    np.testing.assert_array_equal(np.asarray(d_patch), np.asarray(d_sparse))


def test_subpixel_from_patches_matches_refine(rng):
    h, w = 96, 160
    raw = jnp.asarray(rng.rand(h, w).astype(np.float32) * 50.0)
    k = 32
    x = jnp.asarray(rng.randint(20, w - 20, k), jnp.int32)
    y = jnp.asarray(rng.randint(20, h - 20, k), jnp.int32)
    xf_ref, yf_ref = detect._subpixel_refine(raw, x, y)
    xc, yc = pt.clamp_coords(x, y, h, w)
    _, rawp = pt.extract_patches_xla(raw[None], raw[None], xc[None], yc[None],
                                     jnp.ones((1, k), bool))
    xf, yf = detect.subpixel_from_patches(rawp[0], x, y)
    np.testing.assert_array_equal(np.asarray(xf), np.asarray(xf_ref))
    np.testing.assert_array_equal(np.asarray(yf), np.asarray(yf_ref))


def _world_frames(n=2):
    from lvt_tpu.io.synthetic import TexturedWorld

    world = TexturedWorld(width=320, height=128, fx=160.0, fy=160.0,
                          cx=160.0, cy=64.0, baseline=0.3)
    frames = []
    for left, right, _ in world.stereo_sequence(n, speed=0.5):
        frames.append(left.astype(np.uint8))
        frames.append(right.astype(np.uint8))
    return world, jnp.asarray(np.stack(frames))


def test_full_extraction_patch_vs_dense_modes():
    world, imgs = _world_frames()
    base = VOConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height, detection_cell_size=64, max_keypoints_per_cell=32,
    )
    feats_dense = extract.extract_features_batched(
        imgs, base.replace(descriptor_mode="dense"))
    feats_patch = extract.extract_features_batched(
        imgs, base.replace(descriptor_mode="patch"))

    v_d = np.asarray(feats_dense.valid)
    v_p = np.asarray(feats_patch.valid)
    np.testing.assert_array_equal(v_p, v_d)
    assert v_d.sum() > 50  # the scene must actually produce features
    np.testing.assert_array_equal(
        np.asarray(feats_patch.desc)[v_d], np.asarray(feats_dense.desc)[v_d])
    np.testing.assert_array_equal(
        np.asarray(feats_patch.kp)[v_d], np.asarray(feats_dense.kp)[v_d])
    np.testing.assert_array_equal(
        np.asarray(feats_patch.score)[v_d],
        np.asarray(feats_dense.score)[v_d])
