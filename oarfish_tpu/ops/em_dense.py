"""Dense one-hot matmul EM for batched tiny problems (single-cell buckets).

The per-cell EM (`single_cell.rs:141-150` runs one serial scalar EM per
barcode) has per-cell spaces so small (t_pad <= 512 local transcripts,
a_pad <= 4096 alignments after pow2 bucketing) that a dense formulation
is an alternative to sparse gather/scatter: build the two static 0/1
incidence matrices per cell ON DEVICE (iota compare over packed
per-slot indices — the host ships ~12 B/slot, not dense matrices),
once per jitted EM call —

    S [a_pad, t_pad]  alignment -> local transcript (one-hot rows)
    R [r_pad, a_pad]  read -> alignment (contiguous-segment rows)

— and run the fused E/M step (`em.rs:87-133` semantics) as four batched
matmuls:

    contrib = (S @ prev) * w          denom = R @ contrib
    inc     = contrib * (R^T @ scale) curr  = S^T @ inc

Pad rows are all-zero, so padding needs no sentinel slots: pad
alignments contribute nothing, pad reads get denom 0 -> scale 0, and
pad transcripts stay 0. The matrices are stored bf16 (0/1 is exact) and
widened to the compute dtype in the step; matmuls run at
Precision.HIGHEST so f32 `prev`/`contrib` are not rounded to a lower
precision (a DEFAULT f32 dot may run as one bf16 or TF32 pass — about
1e-3 relative error, outside the ~1e-4 parity envelope).

Loop semantics mirror `run_em` exactly (min 50 iters, per-cell
convergence freezing, zero-below-1e-5 + one final step).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import EM_DENOM_THRESH, MIN_READ_THRESH
from .em import _rel_diff, squarem_em


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["txp", "rid", "weights"],
    meta_fields=["t_pad", "r_pad"],
)
@dataclass(frozen=True)
class DenseCellEm:
    """One bucket of cells, PACKED: per-alignment-slot transcript/read
    indices (-1 on pad slots). The dense one-hot incidence matrices are
    built ON DEVICE by iota compare (`densify`), once per jitted EM
    call — the host ships ~12 B/alignment-slot instead of the ~2
    B/matrix-element dense form (a_pad*(t_pad+r_pad)*2 B/cell, ~48 KB
    per cell at the common bucket shape)."""

    txp: jax.Array  # [B, a_pad] i32 local transcript per slot (-1 pad)
    rid: jax.Array  # [B, a_pad] i32 read index per slot (-1 pad)
    weights: jax.Array  # [B, a_pad] f32 (0 on pad slots)
    t_pad: int
    r_pad: int

    @staticmethod
    def build(
        txp_local: List[np.ndarray],
        weights: List[np.ndarray],
        read_id: List[np.ndarray],
        a_pad: int,
        r_pad: int,
        t_pad: int,
        dtype=jnp.float32,
        put=jnp.asarray,
    ) -> "DenseCellEm":
        B = len(txp_local)
        # i16 slot indices when the padded spaces fit (t_pad <= 512,
        # r_pad <= 4096 in practice): cuts the packed-slot host->device
        # transfer from 12 to 8 B/slot. -1 pads fit; densify widens on
        # device (fused into the compare).
        idt = (np.int16 if t_pad <= 32767 and r_pad <= 32767
               else np.int32)
        TX = np.full((B, a_pad), -1, dtype=idt)
        RD = np.full((B, a_pad), -1, dtype=idt)
        W = np.zeros((B, a_pad), dtype=np.float64)
        for i in range(B):
            a = len(txp_local[i])
            TX[i, :a] = txp_local[i]
            RD[i, :a] = read_id[i]
            W[i, :a] = weights[i]
        return DenseCellEm(
            txp=put(TX), rid=put(RD), weights=put(W.astype(dtype)),
            t_pad=t_pad, r_pad=r_pad,
        )

    def densify(self) -> "_DenseSR":
        """One-hot S [B,a_pad,t_pad] / R [B,r_pad,a_pad] in bf16 (0/1
        exact; widened to the compute dtype in the step, as the old
        host-built bf16 matrices were). Pad slots (-1) match no iota
        value, so pad rows/columns are all-zero — the padding semantics
        of the dense form are preserved exactly."""
        iota_t = jnp.arange(self.t_pad, dtype=jnp.int32)
        iota_r = jnp.arange(self.r_pad, dtype=jnp.int32)
        txp = self.txp.astype(jnp.int32)  # i16 transfer form widens here
        rid = self.rid.astype(jnp.int32)
        S = (txp[:, :, None] == iota_t[None, None, :]).astype(
            jnp.bfloat16
        )
        R = (rid[:, None, :] == iota_r[None, :, None]).astype(
            jnp.bfloat16
        )
        return _DenseSR(S=S, R=R, weights=self.weights)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["S", "R", "weights"],
    meta_fields=[],
)
@dataclass(frozen=True)
class _DenseSR:
    """Densified incidence matrices (device-resident, per jitted call)."""

    S: jax.Array  # [B, a_pad, t_pad] bf16 0/1: alignment -> transcript
    R: jax.Array  # [B, r_pad, a_pad] bf16 0/1: read -> alignment
    weights: jax.Array  # [B, a_pad] f32 (0 on pad slots)


def _m_step_dense(data, prev_b: jax.Array) -> jax.Array:
    """One fused E/M step over the bucket batch: four batched matmuls.
    Accepts a densified `_DenseSR` (preferred: densify once outside the
    EM loop) or a packed `DenseCellEm` (densified on the fly)."""
    if isinstance(data, DenseCellEm):
        data = data.densify()
    dt = prev_b.dtype
    hi = jax.lax.Precision.HIGHEST
    S = data.S.astype(dt)
    R = data.R.astype(dt)
    contrib = (
        jnp.einsum("bat,bt->ba", S, prev_b, precision=hi)
        * data.weights.astype(dt)
    )
    denom = jnp.einsum("bra,ba->br", R, contrib, precision=hi)
    scale = jnp.where(denom > EM_DENOM_THRESH, 1.0 / denom, 0.0)
    inc = contrib * jnp.einsum("bra,br->ba", R, scale, precision=hi)
    return jnp.einsum("bat,ba->bt", S, inc, precision=hi)


def _run_em_dense_impl(data, init_b, max_iter, convergence_thresh,
                       min_iters):
    convergence_thresh = jnp.asarray(convergence_thresh, dtype=init_b.dtype)
    B = init_b.shape[0]
    sr = data.densify()  # materialized once per call, loop-invariant

    def cond(state):
        niter, _prev, conv = state
        return jnp.any((niter < max_iter) & (~conv))

    def body(state):
        niter, prev, conv = state
        curr = _m_step_dense(sr, prev)
        rd = jax.vmap(_rel_diff)(prev, curr)
        newly = (rd < convergence_thresh) & (niter > min_iters)
        curr = jnp.where(conv[:, None], prev, curr)
        niter = jnp.where(conv, niter, niter + 1)
        return (niter, curr, conv | newly)

    state0 = (jnp.zeros(B, jnp.int32), init_b, jnp.zeros(B, bool))
    niter, prev, _ = jax.lax.while_loop(cond, body, state0)
    prev = jnp.where(prev < MIN_READ_THRESH, 0.0, prev)
    return _m_step_dense(sr, prev), niter


def _run_em_dense_squarem_impl(data, init_b, max_iter,
                               convergence_thresh, min_iters):
    sr = data.densify()
    return squarem_em(
        lambda p: _m_step_dense(sr, p),
        init_b, max_iter, convergence_thresh, min_iters,
        batched=True,
    )


@functools.partial(jax.jit, static_argnames=("max_iter", "min_iters"))
def run_em_dense(
    data: DenseCellEm,
    init_b: jax.Array,
    max_iter: int,
    convergence_thresh,
    min_iters: int = 50,
):
    """Batched EM loop with per-cell convergence freezing — the exact
    `run_em` protocol (`em.rs:144-255`) over the bucket's leading axis.
    Returns ([B, t_pad] counts, [B] iteration counts)."""
    return _run_em_dense_impl(data, init_b, max_iter,
                              convergence_thresh, min_iters)


@functools.partial(jax.jit, static_argnames=("max_iter", "min_iters"))
def run_em_dense_squarem(
    data: DenseCellEm,
    init_b: jax.Array,
    max_iter: int,
    convergence_thresh,
    min_iters: int = 50,
):
    """SQUAREM-accelerated variant (same protocol as `run_em_squarem`)."""
    return _run_em_dense_squarem_impl(data, init_b, max_iter,
                                      convergence_thresh, min_iters)


@functools.partial(
    jax.jit, static_argnames=("max_iter", "min_iters", "accel")
)
def run_em_dense_scan(
    data: DenseCellEm,
    init_b: jax.Array,
    max_iter: int,
    convergence_thresh,
    min_iters: int = 50,
    accel: bool = False,
):
    """Run a whole bucket as ONE device program: `data` fields carry a
    leading sub-batch axis ([n_sub, sub, a_pad]) and `lax.scan` runs the
    per-sub-batch EM sequentially on device. One transfer in, one fetch
    out instead of one host round trip per sub-batch, and fewer
    launches. Densified S/R exist only inside each
    scan step, so peak device memory stays one sub-batch.
    Returns ([n_sub, sub, t_pad] counts, [n_sub, sub] iters)."""
    impl = _run_em_dense_squarem_impl if accel else _run_em_dense_impl

    def step(_, xs):
        d, init = xs
        cc, ni = impl(d, init, max_iter, convergence_thresh, min_iters)
        return None, (cc, ni)

    _, (counts, niter) = jax.lax.scan(step, None, (data, init_b))
    return counts, niter
