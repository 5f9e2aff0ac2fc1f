"""Precise per-op timing with long fori_loops (signal >> dispatch jitter)."""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

A = 3_000_000
T = 200_000
R = 1_000_000
L = 512
N1, N2 = 20, 60


def timed(f, arg, n):
    import jax

    g = jax.jit(
        lambda p: jax.lax.fori_loop(0, n, lambda i, x: f(x), p)
    )
    out = g(arg)
    np.asarray(out)
    out = g(arg)
    t0 = time.perf_counter()
    np.asarray(out)
    return time.perf_counter() - t0


def bench(name, f, arg):
    d1 = timed(f, arg, N1)
    d2 = timed(f, arg, N2)
    per = (d2 - d1) / (N2 - N1)
    print(f"{name:40s} {per*1e3:9.3f} ms", flush=True)
    return per


def main():
    import jax
    import jax.numpy as jnp

    print("device:", jax.devices()[0], flush=True)
    rng = np.random.default_rng(0)
    rand_idx_T = jnp.asarray(rng.integers(0, T, A).astype(np.int32))
    sorted_idx_T = jnp.asarray(np.sort(rng.integers(0, T, A)).astype(np.int32))
    rand_perm = jnp.asarray(rng.permutation(A).astype(np.int32))
    sorted_idx_A = jnp.asarray(
        np.sort(rng.integers(0, A, A)).astype(np.int32)
    )
    small = jnp.asarray(rng.normal(0, 1, T).astype(np.float32))
    big = jnp.asarray(rng.normal(0, 1, A).astype(np.float32))
    key = jnp.asarray(rng.integers(0, T, A).astype(np.int32))

    bench("elementwise x*1.0001", lambda x: x * 1.0001, big)
    bench("gather A from T (random)", lambda x: small[rand_idx_T] + x, big)
    bench("gather A from T (sorted)", lambda x: small[sorted_idx_T] + x, big)
    bench("gather A from A (random perm)", lambda x: x[rand_perm], big)
    bench("gather A from A (sorted idx)", lambda x: x[sorted_idx_A], big)

    n_tiles = A // L  # A divisible: 3,000,000/512 no... use pad
    Apad = n_tiles * L

    def blocked_cumsum(x):
        x2 = x[:Apad].reshape(n_tiles, L)
        local = jnp.cumsum(x2, axis=1)
        tile_tot = local[:, -1]
        G = jnp.cumsum(tile_tot) - tile_tot
        return (local + G[:, None]).reshape(-1)[0] + x

    bench("blocked cumsum (reshape 512)", blocked_cumsum, big)
    bench("plain cumsum 1d", lambda x: jnp.cumsum(x)[0] + x, big)

    def xla_sort(x):
        _, v = jax.lax.sort([key, x], num_keys=1)
        return v

    bench("sort (i32 key, f32 val)", xla_sort, big)

    def seg_sum_scatter(x):
        return (
            jax.ops.segment_sum(x, sorted_idx_T, T, indices_are_sorted=True)[0]
            + x
        )

    bench("segment_sum sorted (scatter-add)", seg_sum_scatter, big)


if __name__ == "__main__":
    main()
