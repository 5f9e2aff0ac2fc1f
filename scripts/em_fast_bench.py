"""Time the scatter-free EM formulation on the default device vs the baseline."""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

R = 2_000_000
T = 200_000
MEAN_K = 3


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


def main():
    import jax
    import jax.numpy as jnp

    from oarfish_tpu.ops.em_fast import FastEmData, run_em_fast

    print("device:", jax.devices()[0], flush=True)
    txp_id, w, boundaries, read_id, A = make()
    print(f"R={R} T={T} A={A}", flush=True)

    t0 = time.time()
    data, order = FastEmData.build(txp_id, w, boundaries, T, dtype=jnp.float32)
    print(f"layout build: {time.time()-t0:.2f}s "
          f"buckets={data.bucket_rows}", flush=True)
    init = jnp.full(T, R / T, dtype=jnp.float32)

    def timed(n):
        counts, niter = run_em_fast(data, init, n, -1.0)
        t0 = time.perf_counter()
        out = np.asarray(counts)
        return time.perf_counter() - t0, out

    timed(50)
    timed(150)
    t50, c = timed(50)
    t150, c2 = timed(150)
    per = (t150 - t50) / 100
    print(f"fast EM: {per*1e3:.2f} ms/iter  ({R/per:.3g} reads/s/iter)",
          flush=True)
    print(f"mass: {c2.sum():.1f} / {R}", flush=True)


if __name__ == "__main__":
    main()
