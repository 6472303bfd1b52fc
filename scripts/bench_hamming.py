"""Isolate the Hamming-matrix cost at KITTI matching sizes.

Times, per variant, a scan of 8 iterations of a vmapped [S, M, W] x
[S, K, W] Hamming computation (carry-xored inputs so nothing hoists):

    matmul_path  unpack both sides to +-1 bf16 + batched matmul
                 (config.hamming_matmul)
    popcount     8-word XOR + population_count reduction
    unpack       the +-1 unpack of both operands alone
    matmul       batched bf16 matmul alone on pre-unpacked operands

Usage: python scripts/bench_hamming.py [--s 8]
"""

from __future__ import annotations

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from lvt_tpu.ops import hamming as ham

M, K, W = 1024, 1536, 8
ITERS = 8


def timeit(fn, *args, n=10, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    np.asarray(jax.tree_util.tree_leaves(out)[-1])
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    np.asarray(jax.tree_util.tree_leaves(out)[-1])
    return (time.perf_counter() - t0) / n * 1e3


def scan_of(body, *xs):
    @jax.jit
    def run(c0, *xs):
        def f(c, _):
            out = body(c, *xs)
            return c ^ jnp.uint32(1), out
        _, outs = jax.lax.scan(f, c0, jnp.arange(ITERS))
        return outs
    return run


def main():
    from lvt_tpu import runtime

    runtime.require_gpu()   # times the device; never the CPU
    s = int(sys.argv[sys.argv.index("--s") + 1]) if "--s" in sys.argv else 8
    rs = np.random.RandomState(0)
    a = jnp.asarray(rs.randint(0, 2**32, (s, M, W), np.uint64).astype(np.uint32))
    b = jnp.asarray(rs.randint(0, 2**32, (s, K, W), np.uint64).astype(np.uint32))
    c0 = jnp.uint32(0)

    def matmul_path(c, a, b):
        return jax.vmap(lambda x, y: ham.hamming_matrix(
            x ^ c, y ^ c, matmul=True).sum())(a, b)

    def popcount(c, a, b):
        return jax.vmap(lambda x, y: ham.hamming_matrix(
            x ^ c, y ^ c, matmul=False).sum())(a, b)

    def unpack(c, a, b):
        ua = jax.vmap(lambda x: ham._unpack_pm1(x ^ c))(a)
        ub = jax.vmap(lambda y: ham._unpack_pm1(y ^ c))(b)
        return ua.sum(dtype=jnp.float32) + ub.sum(dtype=jnp.float32)

    au = jax.vmap(ham._unpack_pm1)(a)
    bu = jax.vmap(ham._unpack_pm1)(b)

    def matmul(c, au, bu):
        au = au + c.astype(jnp.bfloat16) * 0  # carry-dependence, no hoist
        dot = jax.lax.dot_general(
            au, bu, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)
        return ((256 - dot) * 0.5).astype(jnp.int32).sum(axis=(1, 2))

    for name, fn, args in [
        ("matmul_path", matmul_path, (a, b)),
        ("popcount", popcount, (a, b)),
        ("unpack", unpack, (a, b)),
        ("matmul", matmul, (au, bu)),
    ]:
        ms = timeit(scan_of(fn, *args), c0, *args)
        per = ms / (ITERS * s)
        print(f"S={s} {name:9s} {ms:8.2f} ms/scan  {per * 1e3:8.1f} us/(iter*stream)",
              flush=True)


if __name__ == "__main__":
    main()
