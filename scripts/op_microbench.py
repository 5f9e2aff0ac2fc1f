"""Per-op microbenchmark on the default device: which sparse primitive is slow?

Times individual ops of the EM iteration (random gather, monotonic
gather/repeat, scatter-add segment-sum, cumsum, hierarchical segmented
sum) with the two-length delta method inside fori_loops.
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

A = 3_000_000
T = 200_000
R = 1_000_000
L = 512  # tile width for hierarchical segment sum
N1, N2 = 5, 15


def timed(f, arg, n):
    import jax

    def body(i, x):
        return f(x)

    g = jax.jit(lambda p: jax.lax.fori_loop(0, n, body, p))
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
    gbps = A * 4 / per / 1e9
    print(f"{name:34s} {per*1e3:9.2f} ms  (~{gbps:.1f} GB/s of A-f32)",
          flush=True)


def main():
    import jax
    import jax.numpy as jnp

    print("device:", jax.devices()[0], flush=True)
    rng = np.random.default_rng(0)
    rand_idx_T = jnp.asarray(rng.integers(0, T, A).astype(np.int32))
    rand_perm = jnp.asarray(rng.permutation(A).astype(np.int32))
    sizes = rng.multinomial(A, np.full(R, 1 / R)).astype(np.int64)
    read_id = jnp.asarray(np.repeat(np.arange(R, dtype=np.int32), sizes))
    sorted_t = jnp.asarray(np.sort(rng.integers(0, T, A)).astype(np.int32))
    boundaries = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(sizes, out=boundaries[1:])
    bj = jnp.asarray(boundaries)
    small = jnp.asarray(rng.normal(0, 1, T).astype(np.float32))
    big = jnp.asarray(rng.normal(0, 1, A).astype(np.float32))
    rvec = jnp.asarray(rng.normal(0, 1, R).astype(np.float32))

    bench("elementwise mul A", lambda x: x * 1.0001, big)
    bench("random gather A from T", lambda x: (small[rand_idx_T] + x), big)
    bench("sorted gather A from T", lambda x: (small[sorted_t] + x), big)
    bench("sorted gather A from R (rid)", lambda x: (rvec[read_id] + x), big)
    bench("permutation gather A from A", lambda x: x[rand_perm], big)
    bench("take sorted=True",
          lambda x: jnp.take(small, sorted_t, indices_are_sorted=True) + x,
          big)
    bench("cumsum f32 A", lambda x: jnp.cumsum(x), big)

    def seg_sum_sorted(x):
        return jax.ops.segment_sum(x, sorted_t, T, indices_are_sorted=True)[
            rand_idx_T
        ] * 0.0 + x

    bench("segment_sum sorted->T (+gather)", seg_sum_sorted, big)

    def seg_sum_reads(x):
        return (
            jax.ops.segment_sum(x, read_id, R, indices_are_sorted=True)[read_id]
        )

    bench("segment_sum reads + expand", seg_sum_reads, big)

    n_tiles = A // L

    def hier_segsum(x):
        x2 = x.reshape(n_tiles, L)
        tile = x2.sum(axis=1)
        G = jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.cumsum(tile)])
        local = jnp.cumsum(x2, axis=1)
        flat_local = local.reshape(-1)
        idx = bj[1:] - 1
        S_end = G[idx // L] + flat_local[idx]
        idx0 = bj[:-1] - 1
        S_start = jnp.where(
            bj[:-1] > 0, G[idx0 // L] + flat_local[jnp.maximum(idx0, 0)], 0.0
        )
        return (S_end - S_start)[read_id] * 0.0 + x

    bench("hierarchical segsum reads", hier_segsum, big)


if __name__ == "__main__":
    main()
