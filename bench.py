"""Benchmark: sparse EM inner-loop throughput on the GPU.

Workload: human-transcriptome-scale synthetic CSR (200k transcripts, 2M
reads, ~3 alignments/read, zipf transcript popularity), fixed EM
iterations in f32 on device — the BASELINE.json config-3 shape. Runs the
implementation `--em-impl auto` picks for this problem on the first
device JAX finds, and fails unless that device is a GPU. Prints ONE JSON
line.

`vs_baseline` compares against a vectorized NumPy implementation of the
same m-step on this host's CPU (the reference's m-step is the same O(A)
gather/scatter pattern).

Usage: python bench.py [--quick] [--e2e ...]
"""

import json
import os
import sys
import time

import numpy as np

R = 2_000_000
T = 200_000
MEAN_K = 3
ITERS = 50
RUNS = 5
CPU_ITERS = 3


def make_csr(num_reads=None, num_txps=None, seed=0):
    """Synthetic CSR (defaults: the module-level R and T)."""
    R_ = R if num_reads is None else num_reads
    T_ = T if num_txps is None else num_txps
    rng = np.random.default_rng(seed)
    sizes = rng.geometric(1.0 / MEAN_K, size=R_).clip(1, 100)
    A = int(sizes.sum())
    boundaries = np.zeros(R_ + 1, dtype=np.int64)
    np.cumsum(sizes, out=boundaries[1:])
    # zipf-ish transcript popularity
    pop = rng.zipf(1.3, size=A) % T_
    txp_id = pop.astype(np.int32)
    w = np.exp(rng.normal(0, 0.5, size=A)).astype(np.float32)
    read_id = np.repeat(np.arange(R_, dtype=np.int32), sizes)
    return txp_id, w, boundaries, read_id, A


def build_em(impl, txp_id, w, boundaries, read_id, num_txps, dtype):
    """Device layout for one EM implementation. Returns
    (run, build_s): `run(init, max_iter, thresh)` -> (counts, niter)
    device arrays, and the host+transfer seconds of the layout build."""
    t0 = time.perf_counter()
    R = len(boundaries) - 1
    if impl == "segsum":
        from oarfish_tpu.ops.em import EmData, run_em

        data = EmData.build(txp_id, w, read_id, R, num_txps, dtype=dtype)

        def run(init, max_iter, thresh):
            return run_em(data, init, max_iter, thresh)
    elif impl == "fast":
        from oarfish_tpu.ops.em_fast import FastEmData, run_em_fast

        data, _order = FastEmData.build(
            txp_id, w, boundaries, num_txps, dtype=dtype
        )

        def run(init, max_iter, thresh):
            return run_em_fast(data, init, max_iter, thresh)
    elif impl == "v4":
        from oarfish_tpu.ops.em_v4 import EmV4Data, make_runner

        data, _order = EmV4Data.build(txp_id, w, boundaries, num_txps)
        run = make_runner(data)
    else:
        raise ValueError(f"unknown EM impl {impl!r}")
    import jax

    jax.block_until_ready(data)
    return run, time.perf_counter() - t0


def time_em(run, init, iters, runs):
    """Median seconds of `runs` fixed-length EMs (after one warm-up that
    compiles), each ended by block_until_ready. Returns (median, counts)."""
    counts, niter = run(init, iters, -1.0)
    counts.block_until_ready()
    if int(niter) != iters:
        raise RuntimeError(f"EM ran {int(niter)} iterations, not {iters}")
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        counts, _ = run(init, iters, -1.0)
        counts.block_until_ready()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), np.asarray(counts, dtype=np.float64)


def bench_cpu(txp_id, w, boundaries, read_id, num_txps):
    """Vectorized NumPy m-step (f64, like the reference accumulators):
    the minimum over CPU_ITERS timed iterations."""
    w64 = w.astype(np.float64)
    prev = np.full(num_txps, float(len(boundaries) - 1) / num_txps)
    order = np.argsort(txp_id, kind="stable")
    t_sorted = txp_id[order]
    best = float("inf")
    for _ in range(CPU_ITERS):
        t0 = time.perf_counter()
        contrib = prev[txp_id] * w64
        denom = np.add.reduceat(contrib, boundaries[:-1])
        scale = np.where(denom > 1e-30, 1.0 / denom, 0.0)
        inc = contrib * scale[read_id]
        curr = np.zeros(num_txps)
        np.add.at(curr, t_sorted, inc[order])
        prev = curr
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    if "--e2e" in sys.argv:
        # end-to-end BAM -> quant wall time with host/device phase
        # attribution, delegated to the script
        import runpy

        sys.argv = [
            "scripts/e2e_bench.py",
            *[a for a in sys.argv[1:] if a != "--e2e"],
        ]
        runpy.run_path(
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "scripts", "e2e_bench.py"),
            run_name="__main__",
        )
        return
    r, t, iters = R, T, ITERS
    if "--quick" in sys.argv:
        r, t, iters = 200_000, 50_000, 20

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: first device is {dev.platform!r}, not a GPU")
    from oarfish_tpu.quant.bulk import AUTO_EM_IMPL as impl

    txp_id, w, boundaries, read_id, A = make_csr(r, t)
    sys.stderr.write(f"bench: R={r} T={t} A={A} iters={iters} "
                     f"impl={impl} device={dev.device_kind}\n")
    run, build_s = build_em(impl, txp_id, w, boundaries, read_id, t,
                            jnp.float32)
    init = jnp.full(t, float(r) / t, dtype=jnp.float32)
    dt, counts = time_em(run, init, iters, RUNS)
    cpu_dt = bench_cpu(txp_id, w, boundaries, read_id, t) * iters
    ms_per_iter = 1000.0 * dt / iters
    print(json.dumps({
        "metric": "em_reads_per_sec",
        "value": round(r * iters / dt, 1),
        "unit": f"reads*iters/s (R={r}, T={t}, A={A}, f32, impl={impl})",
        "ms_per_iter": round(ms_per_iter, 4),
        "build_s": round(build_s, 3),
        "mass": float(counts.sum()),
        "vs_baseline": round(cpu_dt / dt, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
