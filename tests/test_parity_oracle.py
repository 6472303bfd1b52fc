"""Trajectory-level parity vs the reference oracle (golden regression).

The reference's acceptance method is trajectory evaluation of its example
drivers (SURVEY.md §4; kitti_example.cpp:33-47). Here: a faithful CPU oracle
of the reference pipeline (tools/oracle) was run over deterministic
synthetic-world scenarios by scripts/make_goldens.py and its trajectories +
ATE stored under tests/golden/. This test runs lvt_tpu over the SAME frames
and asserts its ATE is within margin of the oracle's — proving the
re-design tracks at least as accurately as the reference behavior.
chip_smoke.py runs the same scenarios through the same code on the GPU.
"""

from __future__ import annotations

import numpy as np
import pytest

from tools.oracle.scenarios import (
    GOLDEN_DIR,
    SCENARIOS,
    parity_rows,
    run_lvt,
)


@pytest.mark.parametrize(
    "sc",
    [pytest.param(s, marks=[] if s.name == "fast" else [pytest.mark.slow])
     for s in SCENARIOS],
    ids=[s.name for s in SCENARIOS],
)
def test_trajectory_within_oracle_margin(sc):
    """Three parity axes against the stored oracle run on identical frames:
    absolute trajectory error, 1-frame relative pose error (local drift),
    and rotation RMSE — each bounded by oracle * rel_margin + abs."""
    failures = [
        f"{name}: lvt_tpu {ours:.4f} {unit} > bound "
        f"{bound:.4f} {unit} (oracle {oracle:.4f} {unit})"
        for name, ours, bound, oracle, unit in parity_rows(sc, *run_lvt(sc))
        if ours > bound
    ]
    assert not failures, f"{sc.name}: " + "; ".join(failures)


def test_descriptor_level_parity(rng):
    """The oracle's BRIEF (cv2 boxFilter + NumPy sampling) and lvt_tpu's
    (jnp box sums + dense bit planes) share the pattern and must agree
    bit-for-bit up to float summation order at test-pair equality
    boundaries — a much stronger check than trajectory-level ATE."""
    import cv2
    import jax.numpy as jnp

    from lvt_tpu.ops import brief
    from lvt_tpu.ops.hamming import hamming_matrix
    from tools.oracle import features as feat

    img = rng.uniform(0, 255, (200, 300)).astype(np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 1.5).astype(np.uint8)
    k = 50
    xs = rng.uniform(brief.BORDER + 1, 300 - brief.BORDER - 1, k)
    ys = rng.uniform(brief.BORDER + 1, 200 - brief.BORDER - 1, k)
    kps = [cv2.KeyPoint(float(x), float(y), 7.0) for x, y in zip(xs, ys)]

    kept, desc_bytes = feat.brief_compute(img, kps)
    assert len(kept) == k
    words_oracle = jnp.asarray(
        feat.desc_bytes_to_words(desc_bytes).astype(np.uint32))

    kp_arr = jnp.asarray(np.stack([xs, ys], -1).astype(np.float32))
    d_lvt, valid = brief.compute_descriptors(
        jnp.asarray(img, jnp.float32), kp_arr, jnp.ones(k, bool))
    assert np.asarray(valid).all()

    ham = np.diag(np.asarray(hamming_matrix(words_oracle, d_lvt)))
    assert (ham <= 3).all(), ham.max()
    assert np.median(ham) == 0


@pytest.mark.slow
def test_goldens_tracked_to_completion():
    """The stored oracle runs themselves must not have been LOST — otherwise
    the ATE bound is vacuous."""
    for sc in SCENARIOS:
        golden = np.load(GOLDEN_DIR / f"{sc.name}.npz")
        assert int(golden["final_state"]) == 2, f"{sc.name}: oracle lost"
        assert golden["est_t"].shape == golden["gt_t"].shape
