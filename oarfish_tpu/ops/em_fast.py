"""Scatter-free sparse EM formulation.

This module reformulates the E/M step without scatter-adds: segment
sums become row reductions and cumsum differences, and the only
irregular accesses are two gathers. It was written for a backend whose
scatters were slow; whether it beats the plain segment-sum m-step
(`ops/em.py`) on a given device is a measurement, not an assumption.

* **Denominators** — reads are bucketed by alignment count into dense
  `[rows, K]` tables (power-of-two K, zero-padded). The per-read denom is
  a row reduction; no segment ops at all. Reads are *relabeled* so bucket
  rows are contiguous, making the per-read scale vector a concatenation
  (no scatter).
* **M-step** — alignments sorted by transcript (CSC). The per-transcript
  sum is an exclusive-cumsum difference at the T+1 transcript offsets:
  a tile-local f32 cumsum plus a double-double (TwoSum) prefix over tile
  totals, so f32 mode keeps near-f64 segmented-sum precision (a plain
  f32 cumsum of millions of elements loses whole reads' worth of mass).
* The only remaining irregular accesses are one gather from the `prev`
  counts table (T-sized) and one gather of per-read scales at CSC
  positions (R-sized).

Semantics are identical to `ops/em.py` (`em.rs:144-255` serial path);
parity is enforced by tests against the NumPy oracle.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import EM_DENOM_THRESH, MIN_READ_THRESH

TILE = 512


def _two_sum(a, b):
    s = a + b
    bv = s - a
    err = (a - (s - bv)) + (b - bv)
    return s, err


def _dd_add(x, y):
    """Double-double addition for the associative prefix scan."""
    (xh, xl), (yh, yl) = x, y
    s, e = _two_sum(xh, yh)
    e = e + xl + yl
    hi, lo = _two_sum(s, e)
    return hi, lo


def exclusive_tile_prefix(tile_sums: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Exclusive prefix of tile totals in double-double precision.
    Returns length n+1 arrays (entry n = total), so an offset landing
    exactly at the padded end still resolves."""
    hi, lo = jax.lax.associative_scan(
        _dd_add, (tile_sums, jnp.zeros_like(tile_sums))
    )
    zero = jnp.zeros(1, tile_sums.dtype)
    return (
        jnp.concatenate([zero, hi]),
        jnp.concatenate([zero, lo]),
    )


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "bucket_txp",
        "bucket_w",
        "txp_csc",
        "w_csc",
        "read_csc",
        "txp_offsets",
    ],
    meta_fields=[
        "bucket_rows",
        "num_reads",
        "num_txps",
        "num_tiles",
    ],
)
@dataclass(frozen=True)
class FastEmData:
    """Static device layouts for the scatter-free EM."""

    bucket_txp: Tuple[jax.Array, ...]  # each [rows_b, K_b] i32 (T = pad)
    bucket_w: Tuple[jax.Array, ...]  # each [rows_b, K_b] f32/f64
    txp_csc: jax.Array  # [A_pad] i32 sorted (T = pad)
    w_csc: jax.Array  # [A_pad]
    read_csc: jax.Array  # [A_pad] i32 relabeled read ids (R = pad)
    txp_offsets: jax.Array  # [T+1] i64 offsets into the CSC array
    bucket_rows: Tuple[int, ...]
    num_reads: int
    num_txps: int
    num_tiles: int

    @staticmethod
    def build(
        txp_id: np.ndarray,
        weights: np.ndarray,
        boundaries: np.ndarray,
        num_txps: int,
        dtype=jnp.float32,
    ) -> Tuple["FastEmData", np.ndarray]:
        """Returns (data, read_order) where `read_order[i]` is the original
        read index of relabeled read i (multiplicity vectors must be
        provided in relabeled order)."""
        txp_id = np.asarray(txp_id, dtype=np.int64)
        weights = np.asarray(weights, dtype=np.float64)
        boundaries = np.asarray(boundaries, dtype=np.int64)
        R = len(boundaries) - 1
        A = len(txp_id)
        T = int(num_txps)
        sizes = np.diff(boundaries)

        # --- read buckets by padded alignment count
        bucket_txp: List[jax.Array] = []
        bucket_w: List[jax.Array] = []
        bucket_rows: List[int] = []
        order_parts: List[np.ndarray] = []
        maxk = int(sizes.max()) if R else 1
        K = 1
        ks: List[int] = []
        while K < maxk:
            ks.append(K)
            K *= 2
        ks.append(max(K, 1))
        lo = 0
        for K in ks:
            rows = np.nonzero((sizes > lo) & (sizes <= K))[0]
            lo = K
            if len(rows) == 0:
                continue
            tt = np.full((len(rows), K), T, dtype=np.int32)
            ww = np.zeros((len(rows), K), dtype=np.float64)
            starts = boundaries[rows]
            row_sizes = sizes[rows]
            # ragged fill
            rep = np.repeat(np.arange(len(rows)), row_sizes)
            col = (
                np.arange(int(row_sizes.sum()))
                - np.repeat(
                    np.concatenate([[0], np.cumsum(row_sizes)[:-1]]), row_sizes
                )
            )
            src = np.repeat(starts, row_sizes) + col
            tt[rep, col] = txp_id[src]
            ww[rep, col] = weights[src]
            bucket_txp.append(jnp.asarray(tt))
            bucket_w.append(jnp.asarray(ww, dtype=dtype))
            bucket_rows.append(len(rows))
            order_parts.append(rows)

        read_order = (
            np.concatenate(order_parts) if order_parts else np.empty(0, np.int64)
        )
        # relabel: original read -> new contiguous id
        new_id = np.empty(R + 1, dtype=np.int64)
        new_id[read_order] = np.arange(R)
        new_id[R] = R  # dummy

        # --- CSC layout, padded to TILE
        order = np.argsort(txp_id, kind="stable")
        read_of_aln = np.repeat(np.arange(R, dtype=np.int64), sizes)
        txp_sorted = txp_id[order]
        w_sorted = weights[order]
        read_sorted = new_id[read_of_aln[order]]

        counts = np.bincount(txp_id, minlength=T)
        offsets = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])

        A_pad = ((A + TILE - 1) // TILE) * TILE if A else TILE
        txp_csc = np.full(A_pad, T, dtype=np.int32)
        w_csc = np.zeros(A_pad, dtype=np.float64)
        read_csc = np.full(A_pad, R, dtype=np.int32)
        txp_csc[:A] = txp_sorted
        w_csc[:A] = w_sorted
        read_csc[:A] = read_sorted

        data = FastEmData(
            bucket_txp=tuple(bucket_txp),
            bucket_w=tuple(bucket_w),
            txp_csc=jnp.asarray(txp_csc),
            w_csc=jnp.asarray(w_csc, dtype=dtype),
            read_csc=jnp.asarray(read_csc),
            txp_offsets=jnp.asarray(offsets),
            bucket_rows=tuple(bucket_rows),
            num_reads=R,
            num_txps=T,
            num_tiles=A_pad // TILE,
        )
        return data, read_order


def _m_step_fast(
    data: FastEmData, prev: jax.Array, multiplicity: Optional[jax.Array]
):
    """One fused E/M step, scatter-free."""
    prev_ext = jnp.concatenate([prev, jnp.zeros(1, prev.dtype)])

    # denominators: dense row reductions per bucket
    scales = []
    for tt, ww in zip(data.bucket_txp, data.bucket_w):
        contrib = jnp.take(prev_ext, tt, axis=0) * ww
        denom = contrib.sum(axis=1)
        scales.append(jnp.where(denom > EM_DENOM_THRESH, 1.0 / denom, 0.0))
    scale = jnp.concatenate(scales) if scales else jnp.zeros(0, prev.dtype)
    if multiplicity is not None:
        scale = scale * multiplicity.astype(prev.dtype)
    scale_ext = jnp.concatenate([scale, jnp.zeros(1, prev.dtype)])

    # m-step: inc in CSC order, segmented sum via hierarchical cumsum-diff
    contrib_csc = jnp.take(prev_ext, data.txp_csc) * data.w_csc
    inc = contrib_csc * jnp.take(scale_ext, data.read_csc)
    x2 = inc.reshape(data.num_tiles, TILE)
    local = jnp.cumsum(x2, axis=1)
    g_hi, g_lo = exclusive_tile_prefix(local[:, -1])
    local_flat = jnp.concatenate(
        [jnp.zeros(1, inc.dtype), local.reshape(-1)]
    )

    def prefix_at(pos):
        # exclusive prefix S(pos) = sum(inc[:pos])
        tile = pos // TILE
        hi = jnp.take(g_hi, tile)
        lo = jnp.take(g_lo, tile)
        within = jnp.where(pos % TILE == 0, 0.0, jnp.take(local_flat, pos))
        # pos % TILE == 0 means no in-tile part; local_flat offset by 1
        return hi, lo + within

    # careful: local_flat[pos] = cumsum up to index pos-1 within its tile
    # only when pos is not a tile boundary
    o = data.txp_offsets
    hi2, lo2 = prefix_at(o[1:])
    hi1, lo1 = prefix_at(o[:-1])
    curr = (hi2 - hi1) + (lo2 - lo1)
    return curr.astype(prev.dtype)


def _rel_diff(prev, curr):
    mask = prev > MIN_READ_THRESH
    safe = jnp.where(mask, prev, 1.0)
    rd = jnp.where(mask, (curr - prev) / safe, -jnp.inf)
    return jnp.maximum(jnp.max(rd), 0.0)


@functools.partial(jax.jit, static_argnames=("max_iter", "min_iters"))
def run_em_fast(
    data: FastEmData,
    init: jax.Array,
    max_iter: int,
    convergence_thresh,
    multiplicity: Optional[jax.Array] = None,
    min_iters: int = 50,
):
    """Same loop semantics as `run_em` (`em.rs:144-255`)."""
    convergence_thresh = jnp.asarray(convergence_thresh, dtype=init.dtype)

    def cond(state):
        niter, _prev, converged = state
        return jnp.any((niter < max_iter) & (~converged))

    def body(state):
        niter, prev, converged = state
        curr = _m_step_fast(data, prev, multiplicity)
        rd = _rel_diff(prev, curr)
        newly = (rd < convergence_thresh) & (niter > min_iters)
        curr = jnp.where(converged, prev, curr)
        niter = jnp.where(converged, niter, niter + 1)
        return (niter, curr, converged | newly)

    niter, prev, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), init, jnp.asarray(False))
    )
    prev = jnp.where(prev < MIN_READ_THRESH, 0.0, prev)
    counts = _m_step_fast(data, prev, multiplicity)
    return counts, niter


@functools.partial(jax.jit, static_argnames=("max_iter", "min_iters"))
def run_em_fast_squarem(
    data: FastEmData,
    init: jax.Array,
    max_iter: int,
    convergence_thresh,
    multiplicity: Optional[jax.Array] = None,
    min_iters: int = 50,
):
    """`run_em_fast` with SQUAREM acceleration (`em.squarem_em`)."""
    from .em import squarem_em

    return squarem_em(
        lambda p: _m_step_fast(data, p, multiplicity),
        init, max_iter, convergence_thresh, min_iters,
    )
