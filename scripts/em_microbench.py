"""Microbenchmark of EM inner-loop formulations on the default device.

Compares per-iteration time of several sparse E/M step implementations to
find the speed-of-light formulation (scatter vs cumsum-diff vs bucketed
dense). Timing uses the delta method (two loop lengths) to cancel fixed
launch and transfer latency.
"""

import functools
import sys
import time

import numpy as np

sys.path.insert(0, ".")

R = 1_000_000
T = 200_000
MEAN_K = 3
N1, N2 = 5, 15


def make(seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.geometric(1.0 / MEAN_K, size=R).clip(1, 100)
    A = int(sizes.sum())
    boundaries = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(sizes, out=boundaries[1:])
    txp_id = (rng.zipf(1.3, size=A) % T).astype(np.int32)
    w = np.exp(rng.normal(0, 0.5, size=A)).astype(np.float32)
    read_id = np.repeat(np.arange(R, dtype=np.int32), sizes)
    return txp_id, w, boundaries, read_id, A


def timed_loop(step, prev0, n):
    import jax

    def body(i, prev):
        return step(prev)

    f = jax.jit(lambda p: jax.lax.fori_loop(0, n, body, p), static_argnums=())
    out = f(prev0)
    t0 = time.perf_counter()
    r = np.asarray(out)  # sync
    # second run timed
    out = f(prev0)
    t0 = time.perf_counter()
    r = np.asarray(out)
    return time.perf_counter() - t0, r


def bench(step_factory, name, args):
    import jax.numpy as jnp

    step = step_factory(*args)
    prev0 = jnp.full(T, float(R) / T, dtype=jnp.float32)
    dt1, r1 = timed_loop(step, prev0, N1)
    dt2, r2 = timed_loop(step, prev0, N2)
    per_iter = (dt2 - dt1) / (N2 - N1)
    print(f"{name:28s} {per_iter*1e3:9.2f} ms/iter  (sum={r2.sum():.1f})",
          flush=True)
    return per_iter


def v_segment_sum(txp_id, w, boundaries, read_id):
    """Current production formulation (jax.ops.segment_sum both ways)."""
    import jax
    import jax.numpy as jnp

    perm = np.argsort(txp_id, kind="stable").astype(np.int32)
    t_sorted = jnp.asarray(txp_id[perm])
    permj = jnp.asarray(perm)
    tj = jnp.asarray(txp_id)
    wj = jnp.asarray(w)
    rj = jnp.asarray(read_id)

    def step(prev):
        contrib = prev[tj] * wj
        denom = jax.ops.segment_sum(contrib, rj, R, indices_are_sorted=True)
        scale = jnp.where(denom > 1e-30, 1.0 / denom, 0.0)
        inc = contrib * scale[rj]
        return jax.ops.segment_sum(
            inc[permj], t_sorted, T, indices_are_sorted=True
        )

    return step


def v_cumsum_f32(txp_id, w, boundaries, read_id):
    """Both segmented sums as exclusive-cumsum differences (no scatter)."""
    import jax.numpy as jnp

    perm = np.argsort(txp_id, kind="stable").astype(np.int32)
    csc_off = np.zeros(T + 1, dtype=np.int64)
    np.add.at(csc_off[1:], txp_id, 1)
    np.cumsum(csc_off, out=csc_off)
    tj = jnp.asarray(txp_id)
    wj = jnp.asarray(w)
    rj = jnp.asarray(read_id)
    permj = jnp.asarray(perm)
    bj = jnp.asarray(boundaries)
    cj = jnp.asarray(csc_off)

    def step(prev):
        contrib = prev[tj] * wj
        s1 = jnp.cumsum(contrib)
        s1 = jnp.concatenate([jnp.zeros(1, s1.dtype), s1])
        denom = s1[bj[1:]] - s1[bj[:-1]]
        scale = jnp.where(denom > 1e-30, 1.0 / denom, 0.0)
        inc = contrib * scale[rj]
        s2 = jnp.cumsum(inc[permj])
        s2 = jnp.concatenate([jnp.zeros(1, s2.dtype), s2])
        return s2[cj[1:]] - s2[cj[:-1]]

    return step


def v_cumsum_f64(txp_id, w, boundaries, read_id):
    """Cumsum-diff with f64 accumulators."""
    import jax
    import jax.numpy as jnp

    base = v_cumsum_f32(txp_id, w, boundaries, read_id)
    perm = np.argsort(txp_id, kind="stable").astype(np.int32)
    csc_off = np.zeros(T + 1, dtype=np.int64)
    np.add.at(csc_off[1:], txp_id, 1)
    np.cumsum(csc_off, out=csc_off)
    tj = jnp.asarray(txp_id)
    wj = jnp.asarray(w)
    rj = jnp.asarray(read_id)
    permj = jnp.asarray(perm)
    bj = jnp.asarray(boundaries)
    cj = jnp.asarray(csc_off)

    def step(prev):
        contrib = (prev[tj] * wj).astype(jnp.float64)
        s1 = jnp.cumsum(contrib)
        s1 = jnp.concatenate([jnp.zeros(1, s1.dtype), s1])
        denom = (s1[bj[1:]] - s1[bj[:-1]]).astype(jnp.float32)
        scale = jnp.where(denom > 1e-30, 1.0 / denom, 0.0)
        inc = (contrib.astype(jnp.float32)) * scale[rj]
        s2 = jnp.cumsum(inc[permj].astype(jnp.float64))
        s2 = jnp.concatenate([jnp.zeros(1, s2.dtype), s2])
        return (s2[cj[1:]] - s2[cj[:-1]]).astype(jnp.float32)

    return step


def v_bucket_dense(txp_id, w, boundaries, read_id):
    """Reads padded into one dense [R, Kmax-bucketed] table is wasteful;
    instead: bucket reads by padded k in {1,2,4,8,16,32,64,128}; denom by
    row-sum per bucket; m-step still CSC cumsum-diff."""
    import jax.numpy as jnp

    sizes = np.diff(boundaries)
    K_buckets = [1, 2, 4, 8, 16, 32, 64, 128]
    tables = []
    for K in K_buckets:
        lo = 0 if K == 1 else K_buckets[K_buckets.index(K) - 1]
        rows = np.nonzero((sizes > lo) & (sizes <= K))[0]
        if len(rows) == 0:
            tables.append(None)
            continue
        tid = np.full((len(rows), K), T, dtype=np.int32)
        ww = np.zeros((len(rows), K), dtype=np.float32)
        for i, r in enumerate(rows):
            s, e = boundaries[r], boundaries[r + 1]
            tid[i, : e - s] = txp_id[s:e]
            ww[i, : e - s] = w[s:e]
        tables.append((jnp.asarray(tid), jnp.asarray(ww)))

    def step(prev):
        prev_ext = jnp.concatenate([prev, jnp.zeros(1, prev.dtype)])
        curr = jnp.zeros(T + 1, prev.dtype)
        for tb in tables:
            if tb is None:
                continue
            tid, ww = tb
            contrib = prev_ext[tid] * ww
            denom = contrib.sum(axis=1, keepdims=True)
            scale = jnp.where(denom > 1e-30, 1.0 / denom, 0.0)
            inc = contrib * scale
            curr = curr.at[tid.reshape(-1)].add(inc.reshape(-1))
        return curr[:T]

    return step


def main():
    import jax

    print("device:", jax.devices()[0], flush=True)
    args = make()
    print(f"R={R} T={T} A={args[4]}", flush=True)
    bench(v_segment_sum, "segment_sum (current)", args[:4])
    bench(v_cumsum_f32, "cumsum-diff f32", args[:4])
    bench(v_cumsum_f64, "cumsum-diff f64", args[:4])


if __name__ == "__main__":
    main()
