"""Device throughput for the last two BASELINE configs (VERDICT r1 item 4).

Config 4 — bulk + 100 vmapped bootstraps: the replicate-batched v4
m-step (`run_em_v4_batch` path, B=8 sub-batches as the quant driver
uses, `quant/bulk.py:274`) delta-timed at the official bench shape
(R=2M, T=200k, A~6M). Reports ms/iter for the batch and
replicate*read*iters/s, plus the projected wall for the reference-shaped
job (100 replicates x ~150 iters).

Config 5 — batched single-cell EM: synthetic cells packed into the same
pow2 (a_pad, r_pad, t_pad) buckets the quant path builds
(`quant/single_cell.py:_ceil_pow2`), each bucket's vmapped segsum
m-step delta-timed; reports aggregate cell*iters/s and cells/s for a
100-iteration EM. Reference runs these as a worker-thread pool of
scalar EMs (`single_cell.rs:91-193`).

Timing: every number is a two-loop-length delta with a host transfer
as the sync, so fixed dispatch costs cancel.
Run: python scripts/boot_sc_bench.py [--quick] [--skip-boot|--skip-sc]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

import bench
from oarfish_tpu.cli import enable_persistent_jax_cache

N1, N2 = 20, 120


def delta_time(f1, f2, *args):
    """min-of-2 delta timing: (N2-N1) extra iterations' device time."""
    d = []
    for f in (f1, f2, f1, f2):
        out = f(*args)
        t0 = time.perf_counter()
        res = np.asarray(jax.tree_util.tree_leaves(out)[0])
        d.append(time.perf_counter() - t0)
    d1, d2 = min(d[0], d[2]), min(d[1], d[3])
    return (d2 - d1) / (N2 - N1), res


def bench_bootstrap(quick):
    from oarfish_tpu.ops.em_v4 import EmV4Data, _m_step_v4_b

    if quick:
        bench.R, bench.T = 200_000, 50_000
    txp_id, w, boundaries, read_id, A = bench.make_csr()
    T, R = bench.T, bench.R
    B = 8  # the quant driver's replicate sub-batch (quant/bulk.py:274)
    t0 = time.perf_counter()
    data, order = EmV4Data.build(txp_id, w, boundaries, T)
    sys.stderr.write(f"boot: A={A} T={T} R={R} build "
                     f"{time.perf_counter() - t0:.1f}s\n")
    rng = np.random.default_rng(0)
    mult = rng.multinomial(R, np.full(R, 1.0 / R), size=B)
    mult = jnp.asarray(mult[:, order], dtype=jnp.float32)
    init = jnp.full(T, float(R) / T, dtype=jnp.float32)
    init_b = jnp.broadcast_to(init, (B, T))

    def make(n):
        def f(d, m, i0):
            def body(_, prev):
                return _m_step_v4_b(d, prev, m) * 0.5 + prev * 0.5
            return jax.lax.fori_loop(0, n, body, i0)
        return jax.jit(f)

    dt, res = delta_time(make(N1), make(N2), data, mult, init_b)
    sys.stderr.write(
        f"boot: {dt * 1e3:.2f} ms/iter for B={B} "
        f"({dt / B * 1e3:.3f} ms/iter/replicate) mass={res.sum():.0f}\n"
    )
    # projected: 100 replicates x 150 iters (typical convergence count)
    proj = 100.0 / B * 150.0 * dt
    return {
        "boot_ms_per_iter_B8": round(dt * 1e3, 3),
        "boot_replicate_read_iters_per_s": round(B * R / dt, 1),
        "boot_projected_100x150_s": round(proj, 1),
        "boot_A": A,
        "boot_R": R,
        "boot_T": T,
    }


def make_cells(rng, n_cells, t_global, quick):
    """Synthetic cells: reads/cell lognormal (median ~250), ~2
    alignments/read (geometric), zipf transcript popularity per cell
    over a per-cell active set — the shape the CB-collated path yields."""
    cells = []
    for _ in range(n_cells):
        r_c = int(np.clip(rng.lognormal(np.log(250), 0.6), 20, 2000))
        if quick:
            r_c = min(r_c, 400)
        sizes = rng.geometric(0.5, size=r_c).clip(1, 16)
        a_c = int(sizes.sum())
        # per-cell active transcript set (~10% of reads' worth of txps)
        n_active = max(8, r_c // 4)
        active = rng.choice(t_global, size=n_active, replace=False)
        txp = active[rng.zipf(1.5, size=a_c) % n_active].astype(np.int32)
        w = np.exp(rng.normal(0, 0.5, size=a_c))
        b = np.zeros(r_c + 1, dtype=np.int64)
        np.cumsum(sizes, out=b[1:])
        cells.append((txp, w, b))
    return cells


def bench_single_cell(quick, impls=("segsum", "dense")):
    from oarfish_tpu.ops.em import EmData, _m_step
    from oarfish_tpu.ops.em_dense import DenseCellEm, _m_step_dense
    from oarfish_tpu.quant.single_cell import (
        CellBatch,
        _ceil_pow2,
        coarsen_buckets,
    )

    t_global = 30_000
    n_cells = 512 if quick else 4096
    rng = np.random.default_rng(1)
    cells = make_cells(rng, n_cells, t_global, quick)
    total_reads = sum(len(b) - 1 for _, _, b in cells)

    buckets = {}
    for i, (txp, w, b) in enumerate(cells):
        gids, local = np.unique(txp, return_inverse=True)
        key = (_ceil_pow2(len(txp)), _ceil_pow2(len(b) - 1),
               _ceil_pow2(len(gids)))
        batch = buckets.get(key)
        if batch is None:
            batch = buckets[key] = CellBatch(*key, t_global)
        sizes = np.diff(b)
        rid = np.repeat(np.arange(len(b) - 1, dtype=np.int32), sizes)
        batch.add(i, local.astype(np.int32), w, rid, len(b) - 1, gids)
    buckets = coarsen_buckets(buckets)
    sys.stderr.write(
        f"sc: {n_cells} cells, {total_reads} reads, "
        f"{len(buckets)} buckets: "
        + " ".join(f"{k}x{len(v.cell_index)}"
                   for k, v in sorted(buckets.items())) + "\n"
    )

    def pack(batch):
        B = len(batch.txp_local)
        a_p, r_p, t_p = batch.a_pad, batch.r_pad, batch.t_pad
        txp = np.full((B, a_p), t_p, dtype=np.int32)
        wts = np.zeros((B, a_p), dtype=np.float32)
        rid = np.full((B, a_p), r_p, dtype=np.int32)
        perm = np.zeros((B, a_p), dtype=np.int32)
        tsrt = np.full((B, a_p), t_p, dtype=np.int32)
        init = np.zeros((B, t_p + 1), dtype=np.float32)
        for i in range(B):
            a = len(batch.txp_local[i])
            txp[i, :a] = batch.txp_local[i]
            wts[i, :a] = batch.weights[i]
            rid[i, :a] = batch.read_id[i]
            p = np.argsort(txp[i], kind="stable").astype(np.int32)
            perm[i], tsrt[i] = p, txp[i][p]
            init[i, :] = batch.num_reads[i] / t_global
        return EmData(
            txp_id=jnp.asarray(txp), weights=jnp.asarray(wts),
            read_id=jnp.asarray(rid), txp_sort_perm=jnp.asarray(perm),
            txp_id_sorted=jnp.asarray(tsrt),
            num_reads=r_p + 1, num_txps=t_p + 1,
        ), jnp.asarray(init)

    def pack_dense(batch):
        B = len(batch.txp_local)
        data = DenseCellEm.build(
            batch.txp_local, batch.weights, batch.read_id,
            batch.a_pad, batch.r_pad, batch.t_pad,
        )
        init = np.asarray(batch.num_reads, dtype=np.float64)[:, None] / (
            t_global
        ) * np.ones((B, batch.t_pad))
        return data, jnp.asarray(init.astype(np.float32))

    def make(n, step):
        def f(d, i0):
            def body(_, prev):
                return step(d, prev) * 0.5 + prev * 0.5
            return jax.lax.fori_loop(0, n, body, i0)
        return jax.jit(f)

    steps = {
        "segsum": (
            pack,
            lambda d, p: jax.vmap(lambda dd, pp: _m_step(dd, pp, None))(d, p),
        ),
        "dense": (pack_dense, lambda d, p: _m_step_dense(d, p)),
    }
    out = {
        "sc_cells": n_cells,
        "sc_total_reads": total_reads,
        "sc_buckets": len(buckets),
    }
    for impl in impls:
        packer, step = steps[impl]
        f1, f2 = make(N1, step), make(N2, step)
        dev_s_per_iter = 0.0
        for key in sorted(buckets):
            batch = buckets[key]
            data, init = packer(batch)
            dt, _ = delta_time(f1, f2, data, init)
            dev_s_per_iter += max(dt, 0.0)
            sys.stderr.write(
                f"sc[{impl}] bucket {key} B={len(batch.cell_index)}: "
                f"{dt * 1e3:.3f} ms/iter\n"
            )
        cell_iters_per_s = n_cells / dev_s_per_iter
        out[f"sc_{impl}_cell_iters_per_s"] = round(cell_iters_per_s, 1)
        out[f"sc_{impl}_cells_per_s_100iter"] = round(
            cell_iters_per_s / 100.0, 1
        )
        out[f"sc_{impl}_device_s_per_iter"] = round(dev_s_per_iter, 5)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--skip-boot", action="store_true")
    ap.add_argument("--skip-sc", action="store_true")
    ap.add_argument("--sc-impl", default="segsum,dense",
                    help="comma list of single-cell arms to time")
    args = ap.parse_args()
    enable_persistent_jax_cache()
    out = {"device": jax.devices()[0].platform}
    if not args.skip_sc:
        out.update(
            bench_single_cell(args.quick, args.sc_impl.split(","))
        )
    if not args.skip_boot:
        out.update(bench_bootstrap(args.quick))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
