"""Device throughput for BASELINE configs 4-5: vmapped bootstrap
replicates (bulk + 100 bootstraps) and batched single-cell EMs.

Config 4 (bootstrap): the production path — v4 routed EM with the
replicate axis vmapped in sub-batches of 8 (`run_em_v4_batch`,
`quant/bulk.py` bootstrap branch) at the bench CSR shape (R=2M,
T=200k, A~6M). Reported as replicate-iterations/s and
read*replicate*iters/s.

Config 5 (single-cell): the production bucket machinery
(`quant/single_cell.py` CellBatch.run — vmapped padded per-cell EMs)
on a synthetic bucket of cells. Reported as cell-iterations/s and
cells/s at 100 fixed iterations.

Every number is the DELTA of two loop lengths (fixed dispatch and
transfer costs cancel). Runs on the default device; --platform cpu for
an offline smoke.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def bench_bootstrap(B=8, iters_small=30, iters_big=90):
    import jax.numpy as jnp

    import bench
    from oarfish_tpu.ops import bootstrap as bootstrap_ops
    from oarfish_tpu.ops.em_v4 import EmV4Data, run_em_v4_batch

    txp_id, w, boundaries, read_id, A = bench.make_csr()
    T, R = bench.T, bench.R
    t0 = time.perf_counter()
    data, order = EmV4Data.build(txp_id, w, boundaries, T)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    mult = bootstrap_ops.sample_multiplicities(rng, B, R)[:, order]
    mult_j = jnp.asarray(mult, dtype=jnp.float32)
    init = jnp.full(T, float(R) / T, dtype=jnp.float32)

    def timed(n_iters):
        # convergence_thresh=-1: never converges -> exactly n_iters
        cb, niter = run_em_v4_batch(data, init, n_iters, -1.0, mult_j)
        t0 = time.perf_counter()
        out = np.asarray(cb)
        dt = time.perf_counter() - t0
        assert out.shape == (B, T)
        return dt, out

    timed(iters_small)  # compile + warm-up
    timed(iters_big)
    t_s, out = timed(iters_small)
    t_b, _ = timed(iters_big)
    dt = t_b - t_s
    n_extra = iters_big - iters_small
    if dt <= 0:
        dt = max(t_b / 3, 1e-9)
    per_rep_iter = dt / (n_extra * B)
    return {
        "B": B,
        "A": A,
        "R": R,
        "ms_per_replicate_iter": round(per_rep_iter * 1e3, 3),
        "replicate_iters_per_s": round(1.0 / per_rep_iter, 1),
        "read_rep_iters_per_s": round(R / per_rep_iter, 0),
        "est_wall_100_bootstraps_s": round(per_rep_iter * 100 * 200, 1),
        "route_build_s": round(build_s, 1),
        "mass_ok": bool(abs(float(out.sum()) / (B * R) - 1.0) < 1e-3),
    }


def bench_single_cell(n_cells=4096, iters_small=40, iters_big=120):
    from oarfish_tpu.config import Args
    from oarfish_tpu.quant.single_cell import CellBatch

    rng = np.random.default_rng(1)
    T_GLOBAL = 200_000
    a_pad, r_pad, t_pad = 1024, 512, 256
    batch = CellBatch(a_pad, r_pad, t_pad, T_GLOBAL)
    for c in range(n_cells):
        n_reads = int(rng.integers(200, r_pad))
        t_local = int(rng.integers(40, t_pad))
        sizes = rng.geometric(1.0 / 2.0, size=n_reads).clip(1, 8)
        a = int(sizes.sum())
        while a > a_pad:
            sizes = sizes[:-1]
            a = int(sizes.sum())
        n_reads = len(sizes)
        read_id = np.repeat(np.arange(n_reads, dtype=np.int32),
                            sizes).astype(np.int32)
        txp_local = rng.integers(0, t_local, size=a).astype(np.int32)
        wts = np.exp(rng.normal(0, 0.5, size=a))
        gids = rng.choice(T_GLOBAL, size=t_local, replace=False)
        batch.add(c, txp_local, wts, read_id, n_reads, gids)

    import jax.numpy as jnp

    def timed(n_iters):
        args = Args(output=Path("/tmp/x"), max_em_iter=n_iters,
                    convergence_thresh=-1.0)
        t0 = time.perf_counter()
        out = batch.run(args, jnp.float32)
        dt = time.perf_counter() - t0
        assert len(out) == n_cells
        return dt

    timed(iters_small)  # compile + warm
    timed(iters_big)
    t_s = timed(iters_small)
    t_b = timed(iters_big)
    dt = t_b - t_s
    n_extra = iters_big - iters_small
    if dt <= 0:
        dt = max(t_b / 3, 1e-9)
    per_cell_iter = dt / (n_extra * n_cells)
    return {
        "cells": n_cells,
        "pads": [a_pad, r_pad, t_pad],
        "us_per_cell_iter": round(per_cell_iter * 1e6, 3),
        "cell_iters_per_s": round(1.0 / per_cell_iter, 0),
        "cells_per_s_at_100_iters": round(1.0 / (per_cell_iter * 100), 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", choices=["bootstrap", "sc"], default=None)
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    if args.quick:
        import bench

        bench.R, bench.T = 200_000, 50_000
    out = {}
    if args.only in (None, "bootstrap"):
        out["bootstrap"] = bench_bootstrap(
            B=4 if args.quick else 8,
            iters_small=10 if args.quick else 30,
            iters_big=30 if args.quick else 90,
        )
        sys.stderr.write(f"bootstrap: {out['bootstrap']}\n")
    if args.only in (None, "sc"):
        out["single_cell"] = bench_single_cell(
            n_cells=256 if args.quick else 4096,
        )
        sys.stderr.write(f"single_cell: {out['single_cell']}\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
