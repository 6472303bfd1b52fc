"""Fixed-capacity per-frame feature container.

Equivalent of the reference's ``lvt_image_features_struct``
(lvt/src/lvt_image_features_struct.h:37-88): a structure-of-arrays padded to
the static keypoint capacity with a validity mask. The 25px spatial hash grid
of the reference has no equivalent here — dense masked Hamming matrices
replace hash-bucket candidate gathering (see lvt_tpu.ops.hamming).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from lvt_tpu.ops.hamming import DESC_WORDS


class FrameFeatures(NamedTuple):
    """Detected keypoints + descriptors of one image, padded to capacity K."""

    kp: jnp.ndarray      # [K, 2] float32 pixel positions (x, y)
    desc: jnp.ndarray    # [K, DESC_WORDS] uint32 packed BRIEF bits
    score: jnp.ndarray   # [K] float32 detector response
    depth: jnp.ndarray   # [K] float32 per-keypoint depth (RGB-D), else 0
    valid: jnp.ndarray   # [K] bool

    @property
    def capacity(self) -> int:
        return self.kp.shape[-2]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid, axis=-1)

    @staticmethod
    def empty(capacity: int) -> "FrameFeatures":
        return FrameFeatures(
            kp=jnp.zeros((capacity, 2), jnp.float32),
            desc=jnp.zeros((capacity, DESC_WORDS), jnp.uint32),
            score=jnp.zeros((capacity,), jnp.float32),
            depth=jnp.zeros((capacity,), jnp.float32),
            valid=jnp.zeros((capacity,), bool),
        )

    @staticmethod
    def from_arrays(kp, desc, score=None, depth=None, valid=None) -> "FrameFeatures":
        k = kp.shape[-2]
        return FrameFeatures(
            kp=jnp.asarray(kp, jnp.float32),
            desc=jnp.asarray(desc, jnp.uint32),
            score=(jnp.zeros((k,), jnp.float32) if score is None
                   else jnp.asarray(score, jnp.float32)),
            depth=(jnp.zeros((k,), jnp.float32) if depth is None
                   else jnp.asarray(depth, jnp.float32)),
            valid=(jnp.ones((k,), bool) if valid is None
                   else jnp.asarray(valid, bool)),
        )
