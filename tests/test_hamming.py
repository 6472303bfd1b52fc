"""Hamming matcher vs numpy oracle + reference acceptance-rule semantics."""

import jax.numpy as jnp
import numpy as np

from lvt_tpu.ops import hamming


def np_hamming(a, b):
    bits_a = np.unpackbits(a.view(np.uint8), axis=-1)
    bits_b = np.unpackbits(b.view(np.uint8), axis=-1)
    return (bits_a[:, None, :] != bits_b[None, :, :]).sum(-1)


def rand_desc(rng, n):
    return rng.randint(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def test_hamming_matrix_matches_oracle(rng):
    a, b = rand_desc(rng, 33), rand_desc(rng, 57)
    got = np.asarray(hamming.hamming_matrix(jnp.array(a), jnp.array(b)))
    np.testing.assert_array_equal(got, np_hamming(a, b))


def test_hamming_zero_and_full(rng):
    a = rand_desc(rng, 4)
    d = np.asarray(hamming.hamming_matrix(jnp.array(a), jnp.array(a)))
    np.testing.assert_array_equal(np.diag(d), 0)
    inv = a ^ np.uint32(0xFFFFFFFF)
    d2 = np.asarray(hamming.hamming_matrix(jnp.array(a), jnp.array(inv)))
    np.testing.assert_array_equal(np.diag(d2), 256)


def test_matmul_hamming_is_exact(rng):
    """The +-1 bf16 product path (config.hamming_matmul) is bit-identical
    to XOR+popcount: every partial sum is an integer <= 256."""
    a = jnp.asarray(rand_desc(rng, 64))
    b = jnp.asarray(rand_desc(rng, 96))
    np.testing.assert_array_equal(
        np.asarray(hamming.hamming_matrix(a, b, matmul=True)),
        np.asarray(hamming.hamming_matrix(a, b)),
    )


def test_masked_top2():
    dist = jnp.array([[5, 3, 9, 1], [7, 2, 2, 8]], jnp.int32)
    mask = jnp.array([[1, 1, 1, 0], [0, 1, 1, 0]], bool)
    d1, d2, best, n = hamming.masked_top2(dist, mask)
    np.testing.assert_array_equal(d1, [3, 2])
    np.testing.assert_array_equal(d2, [5, 2])
    np.testing.assert_array_equal(best, [1, 1])  # ties -> lowest index wins
    np.testing.assert_array_equal(n, [3, 2])


def test_masked_top2_int_matches_generic(rng):
    """The packed-key fast path is semantics-identical to masked_top2,
    including argmin tie-breaking and the no/one-candidate defaults."""
    dist = jnp.asarray(rng.randint(0, 257, (60, 90)).astype(np.int32))
    mask = jnp.asarray(rng.rand(60, 90) > 0.6)
    mask = mask.at[0].set(False)       # zero-candidate row
    mask = mask.at[1, :].set(False)
    mask = mask.at[1, 7].set(True)     # single-candidate row
    ref = hamming.masked_top2(dist, mask)
    got = hamming.masked_top2_int(dist, mask)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))


class TestAcceptRules:
    """Reference: ratio test with >=2 candidates, absolute test with exactly 1
    (lvt_image_features_struct.cpp:104-120)."""

    def run(self, d1, d2, n_cand, ratio=0.8, absth=25.0):
        out = hamming.accept_matches(
            jnp.array([d1], jnp.float32), jnp.array([d2], jnp.float32),
            jnp.array([7]), jnp.array([n_cand]), ratio, absth,
        )
        return int(out[0])

    def test_ratio_pass(self):
        assert self.run(10, 20, 5) == 7

    def test_ratio_fail(self):
        assert self.run(19, 20, 5) == -1

    def test_single_candidate_absolute_pass(self):
        assert self.run(24, 1e9, 1) == 7

    def test_single_candidate_absolute_fail(self):
        assert self.run(26, 1e9, 1) == -1

    def test_no_candidates(self):
        assert self.run(1e9, 1e9, 0) == -1

    def test_zero_distances_rejected(self):
        # d1 == d2 == 0 with 2 candidates: 0/0 ratio must not accept
        assert self.run(0, 0, 2) == -1


def test_resolve_one_to_one():
    # queries 0,1 both want target 3; query 1 is closer. query 2 wants 0.
    match = jnp.array([3, 3, 0, -1])
    d1 = jnp.array([10.0, 4.0, 7.0, 1e9])
    out = np.asarray(hamming.resolve_one_to_one(match, d1, num_targets=5))
    np.testing.assert_array_equal(out, [-1, 3, 0, -1])


def test_resolve_tie_breaks_by_query_index():
    match = jnp.array([2, 2])
    d1 = jnp.array([5.0, 5.0])
    out = np.asarray(hamming.resolve_one_to_one(match, d1, num_targets=3))
    np.testing.assert_array_equal(out, [2, -1])
