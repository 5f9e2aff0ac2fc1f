"""Static permutation and gather networks, applied as plain JAX.

`DeviceTilePlan` routes any fixed permutation of a `[R,128]` tile through
the three-stage decomposition of `permute_plan.py`: a 128-lane row
shuffle, a column stage (an independent row permutation per column, run
in transposed space block by block: each destination 128-row block
stores, per element, its source block and source lane as int8), and a
second lane shuffle.

`GlobalRoute` lifts this to arbitrary-length arrays as a rectangular
gather network: chunk the input, expand each chunk into a
destination-bucket/quota layout, exchange quota buckets between chunks
with one dense transpose, and reduce each destination chunk into final
order. Every stage is `_stage_apply` mapped over chunks; XLA lowers the
lane shuffles and the block gather to ordinary gathers.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .permute_plan import (
    LANES,
    TilePermutePlan,
    edge_color_batch,
    route_tables_native,
)


@dataclass(frozen=True)
class DeviceTilePlan:
    """Compact static routing for one [R,128] tile (2-3 B/element)."""

    r1: np.ndarray  # [R,128] i8: stage-1 lane gather
    r2: np.ndarray  # [R,128] i8: stage-3 lane gather
    col_src: np.ndarray  # [H,128,128] i8: source block per (dst blk, c, r')
    col_lane: np.ndarray  # [H,128,128] i8: source lane within block
    rows: int

    @staticmethod
    def build(perm: np.ndarray, rows: int) -> "DeviceTilePlan":
        base = TilePermutePlan.build(perm, rows)
        R = rows
        H = R // LANES
        assert R % LANES == 0 and H <= 127
        src_row = base.col_perm  # [R,128]: source row feeding (r, c)
        col_src = np.zeros((H, LANES, LANES), dtype=np.int8)
        col_lane = np.zeros((H, LANES, LANES), dtype=np.int8)
        for hd in range(H):
            rs = src_row[hd * LANES : (hd + 1) * LANES, :]  # [r'_d, c]
            col_src[hd] = (rs // LANES).astype(np.int8).T  # [c, r'_d]
            col_lane[hd] = (rs % LANES).astype(np.int8).T
        return DeviceTilePlan(
            r1=base.r1.astype(np.int8),
            r2=base.r2.astype(np.int8),
            col_src=col_src,
            col_lane=col_lane,
            rows=R,
        )

    def apply_numpy(self, x: np.ndarray) -> np.ndarray:
        R, H = self.rows, self.rows // LANES
        t = x.reshape(R, LANES)
        s1 = np.take_along_axis(t, self.r1.astype(np.int64), axis=1)
        blocks = [s1[h * LANES : (h + 1) * LANES].T for h in range(H)]
        out_blocks = []
        for hd in range(H):
            acc = np.zeros((LANES, LANES), dtype=t.dtype)
            lane = self.col_lane[hd].astype(np.int64)
            for hs in range(H):
                g = np.take_along_axis(blocks[hs], lane, 1)
                acc = np.where(self.col_src[hd] == hs, g, acc)
            out_blocks.append(acc.T)
        s2 = np.concatenate(out_blocks, axis=0)
        s3 = np.take_along_axis(s2, self.r2.astype(np.int64), axis=1)
        return s3.reshape(-1)



def _stage_apply(x, r1, src, row_t, r2, mask, H_in, H_out):
    """One gather-network stage on one chunk: [R_in,128] -> [R_out,128].
    Lane shuffle (element -> channel), per-output-block channel delivery
    (each element of output block `ho` reads input block `src[ho]` at
    row `row_t[ho]`; `src` is None when H_in == 1), lane shuffle to the
    final lane (+ static zero mask for outputs not covered by data).
    A tile permute is the square case H_in == H_out."""
    s1 = jnp.take_along_axis(x, r1.astype(jnp.int32), axis=1)
    # [block, channel, row-in-block]
    blocks = jnp.swapaxes(s1.reshape(H_in, LANES, LANES), 1, 2)
    chan = jnp.arange(LANES, dtype=jnp.int32)[None, :, None]
    src_h = 0 if src is None else src.astype(jnp.int32)
    acc = blocks.at[src_h, chan, row_t.astype(jnp.int32)].get(
        mode="fill", fill_value=0
    )  # [H_out, channel, out-row-in-block]
    q = jnp.swapaxes(acc, 1, 2).reshape(H_out * LANES, LANES)
    out = jnp.take_along_axis(q, r2.astype(jnp.int32), axis=1)
    if mask is not None:
        out = jnp.where(mask != 0, out, 0.0)
    return out


def _apply_chunks(xc, r1, src, row, r2, mask, H_in, H_out):
    """`_stage_apply` over the leading chunk axis of `xc` and the tables."""
    return jax.vmap(
        functools.partial(_stage_apply, H_in=H_in, H_out=H_out)
    )(xc, r1, src, row, r2, mask)


@functools.partial(jax.jit, static_argnames=("rows", "n_tiles"))
def _run_batch(x, r1, r2, src, lane, rows, n_tiles):
    H = rows // LANES
    out = _apply_chunks(
        x.reshape(n_tiles, rows, LANES), r1, src, lane, r2, None, H, H
    )
    return out.reshape(n_tiles * rows, LANES)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["r1", "r2", "src", "lane"],
    meta_fields=["rows", "n_tiles"],
)
@dataclass(frozen=True)
class BatchTilePermute:
    """A batch of per-tile static permutations.
    A pytree: the routing arrays travel as jit ARGUMENTS (closure capture
    would inline hundreds of MB of metadata into the HLO)."""

    r1: jax.Array
    r2: jax.Array
    src: jax.Array
    lane: jax.Array
    rows: int
    n_tiles: int

    @staticmethod
    def build(plans: List[DeviceTilePlan]) -> "BatchTilePermute":
        return BatchTilePermute(
            r1=jnp.asarray(np.stack([p.r1 for p in plans])),
            r2=jnp.asarray(np.stack([p.r2 for p in plans])),
            src=jnp.asarray(np.stack([p.col_src for p in plans])),
            lane=jnp.asarray(np.stack([p.col_lane for p in plans])),
            rows=plans[0].rows,
            n_tiles=len(plans),
        )

    def __call__(self, x: jax.Array) -> jax.Array:
        x2 = x.reshape(self.n_tiles * self.rows, LANES)
        out = _run_batch(
            x2, self.r1, self.r2, self.src, self.lane,
            self.rows, self.n_tiles,
        )
        return out.reshape(-1)


# ---------------------------------------------------------------------------
# Global (arbitrary length) static routing
# ---------------------------------------------------------------------------

CH = 128 * LANES  # elements per chunk (16384)


def _roundup(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# GlobalRoute: rectangular gather networks
# ---------------------------------------------------------------------------
#
# The map only covers the REAL elements (a partial injective map),
# quota-pad garbage is never read back, and output pads are zeroed by a
# static mask. Per chunk:
#
#   stage 1 (expand, [128,128] -> [R1,128]): lane shuffle into channel
#     columns, a column-stage gather delivering each channel to its
#     quota row (H_o block gathers from ONE source block), and a lane
#     shuffle to the final quota lane;
#   XLA dense transpose of the [n_src, n_dst, Q] quota tensor;
#   stage 3 (reduce, [R3,128] -> [128,128]): mirrored, with an output
#     zero-mask for the bijection pads that no longer need routing.
#
# Channel assignments are two independent bipartite edge colorings per
# chunk ((input row, quota row) and (quota row, output row)), always
# 128-colorable (Konig); irregular degrees are regularized with dummy
# edges before coloring.


def route_maxflow(out_idx: np.ndarray, in_idx: np.ndarray,
                  n_pad: int, chunk: int = CH,
                  n_pad_out: Optional[int] = None) -> int:
    """Max per-(src,dst)-chunk flow of the partial map — the quota Q a
    GlobalRoute needs. Exposed so shard-uniform plans can take the max
    over shards before forcing a common geometry. `n_pad_out` sizes the
    dst space when it differs from the src space (rectangular routes)."""
    n_src = n_pad // chunk
    n_dst = (n_pad if n_pad_out is None else n_pad_out) // chunk
    from .balance import flows2d

    flows = flows2d(in_idx, out_idx, chunk, n_src, n_dst)
    if flows is None:
        flows = np.zeros((n_src, n_dst), dtype=np.int64)
        np.add.at(
            flows,
            (np.asarray(in_idx) // chunk, np.asarray(out_idx) // chunk),
            1,
        )
    return max(int(flows.max()), 1)


def select_route_geometry(n_ch: int, maxflow: int,
                          q128: bool = False) -> Tuple[int, int]:
    """(chunk-pad, Q) selection: require n_chunks * Q % 16384 == 0 on
    BOTH sides so the quota exchange in __call__ is a pure
    reshape/transpose/reshape (no slice, no zero-pad set). Padding the
    chunk count up
    legalizes finer Q granularity; minimize grid area n_pad*Q,
    tie-broken toward fewer chunks.

    With `q128` the quota is additionally rounded to a multiple of 128
    (whole lane tiles): the exchange then needs no transpose at all —
    stage 3 (and the fused middle) read their dst-chunk column slab
    straight out of the src-major quota tensor (`reduce_strided`).
    Costs quota area; `route_config` applies the break-even rule."""
    import math as _math

    best = None
    for gran in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024):
        npd = _roundup(n_ch, gran)
        q_step = (LANES * LANES) // _math.gcd(LANES * LANES, npd)
        if q128:
            q_step = q_step * LANES // _math.gcd(q_step, LANES)
        q = _roundup(maxflow, q_step)
        if best is None or (npd * q, npd) < (best[0], best[1]):
            best = (npd * q, npd, q)
    _, npd, Q = best
    return npd, Q


def _chunk_view(x, n_chunks, R, strided_qr):
    """[n_chunks, R, 128] view of one replicate's stage input. With
    `strided_qr` the input is the PRE-exchange quota tensor
    [n_other, n_chunks, Qr, 128], and chunk j's rows are column slab j
    of every source chunk (the transpose-free exchange, see
    GlobalRoutePlan.reduce_strided)."""
    if strided_qr:
        x = jnp.swapaxes(x, 0, 1)
    return x.reshape(n_chunks, R, LANES)


@functools.partial(
    jax.jit,
    static_argnames=("n_chunks", "R_in", "R_out", "has_mask",
                     "strided_qr", "B"),
)
def _run_route_stage(x, r1, src, row, r2, mask, n_chunks, R_in, R_out,
                     has_mask, mul=None, strided_qr=0, B=0):
    """One gather-network stage over all chunks. With `B > 0`, `x` (and
    the output) carry a leading replicate axis ([B, n_chunks*R_in, 128],
    strided: [B, n_src, n_dst, Qr, 128]); `mul` (elementwise weights on
    the input) and the tables are shared across replicates."""
    H_in = R_in // LANES
    H_out = R_out // LANES
    assert not (mul is not None and strided_qr)

    def one(v):
        xc = _chunk_view(v, n_chunks, R_in, strided_qr)
        if mul is not None:
            xc = xc * mul.reshape(n_chunks, R_in, LANES)
        out = _apply_chunks(xc, r1, src, row, r2,
                            mask if has_mask else None, H_in, H_out)
        return out.reshape(n_chunks * R_out, LANES)

    return jax.vmap(one)(x) if B else one(x)


def _middle_apply(y, lvl, a_r1, a_src, a_row, a_r2, a_mask,
                  b_r1, b_src, b_row, b_r2, mult, H_q, H_c, thresh,
                  max_lvl):
    """Fused EM middle for one read chunk: gather the (post-exchange)
    quota values into chunk space (route A's reduce stage), compute the
    per-read denominators, turn them into guarded reciprocal scales,
    scale the chunk values, and re-expand into route B's quota layout
    (route B's expand stage). Works because route B's quota layout is
    exactly the transpose of route A's (same flows, identical ranks), so
    the input and output tiles have the same [R_q, 128] shape per chunk.

    Denominators exploit the bucket layout: every read's K slots are K
    CONSECUTIVE rows, K is a power of two, and groups are K-aligned
    (em_v4 `align_groups`). A row BUTTERFLY computes, in step s,
    y[r] += y[r XOR 2^(s-1)], after which y[r] is the sum of the aligned
    2^s-row span containing r; each row then selects the step matching
    its bucket via a static per-row log2(K) table (-1 for non-data rows
    -> scale 0)."""
    R_c = H_c * LANES
    x = _stage_apply(y, a_r1, a_src, a_row, a_r2, a_mask, H_q, H_c)
    lvl = lvl.astype(jnp.int32)
    denom = jnp.where(lvl == 0, x, 0.0)
    s = x
    row = jax.lax.broadcasted_iota(jnp.int32, (R_c, LANES), 0)
    for k in range(1, max_lvl + 1):
        m = 1 << (k - 1)
        up = jnp.roll(s, -m, axis=0)  # s[r + m]
        down = jnp.roll(s, m, axis=0)  # s[r - m]
        # partner rows never cross an aligned 2^k block, so the
        # circular wrap rows are never selected
        s = s + jnp.where((row & m) != 0, down, up)
        denom = jnp.where(lvl == k, s, denom)
    scale = jnp.where(denom > thresh, 1.0 / denom, 0.0)
    xs = x * scale
    if mult is not None:
        xs = xs * mult
    return _stage_apply(xs, b_r1, b_src, b_row, b_r2, None, H_c, H_q)


@functools.partial(
    jax.jit,
    static_argnames=("n_chunks", "R_q", "R_c", "thresh", "max_lvl",
                     "strided_qr", "B"),
)
def _run_middle_stage(y2, lvl, a_r1, a_src, a_row, a_r2, a_mask,
                      b_r1, b_src, b_row, b_r2, n_chunks, R_q, R_c,
                      thresh, max_lvl, mult=None, strided_qr=0, B=0):
    """Fused EM middle over all read chunks. With `B > 0`, `y2`, `mult`
    and the output carry a leading replicate axis; the stage tables and
    `lvl` are shared across replicates."""
    H_q = R_q // LANES
    H_c = R_c // LANES
    body = functools.partial(_middle_apply, H_q=H_q, H_c=H_c,
                             thresh=thresh, max_lvl=max_lvl)
    lvl_c = lvl.reshape(n_chunks, R_c, LANES)

    def one(y, m):
        yc = _chunk_view(y, n_chunks, R_q, strided_qr)
        mc = None if m is None else m.reshape(n_chunks, R_c, LANES)
        out = jax.vmap(body)(yc, lvl_c, a_r1, a_src, a_row, a_r2, a_mask,
                             b_r1, b_src, b_row, b_r2, mc)
        return out.reshape(n_chunks * R_q, LANES)

    return jax.vmap(one)(y2, mult) if B else one(y2, mult)


def batched_device_tables(groups, slabs=None):
    """Ship nested groups of host int8 tables to the device in ONE
    transfer (one concatenated buffer + device-side slices instead of a
    host->device request per table). `groups` is a list of lists (None
    entries preserved); returns the same structure holding device
    arrays. `slabs`, when given, is one contiguous int8 buffer per
    group already holding that group's tables in order (GlobalRoute
    carves its tables from such a slab): the host-side concatenate is
    skipped and the slabs ship as-is, one transfer per group."""
    if slabs is not None:
        bigs = [jnp.asarray(s) for s in slabs]
        out = []
        for g, big in zip(groups, bigs):
            og = []
            off = 0
            for t in g:
                if t is None:
                    og.append(None)
                else:
                    n = int(t.size)
                    og.append(big[off:off + n].reshape(t.shape))
                    off += n
            out.append(og)
        return out
    flat = []
    for g in groups:
        for t in g:
            if t is not None:
                flat.append(np.ascontiguousarray(t).ravel())
    if not flat:
        return [list(g) for g in groups]
    big = jnp.asarray(np.concatenate(flat))
    out = []
    off = 0
    for g in groups:
        og = []
        for t in g:
            if t is None:
                og.append(None)
            else:
                n = int(t.size)
                og.append(big[off:off + n].reshape(t.shape))
                off += n
        out.append(og)
    return out


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["s1_r1", "s1_src", "s1_row", "s1_r2", "s3_r1", "s3_src",
                 "s3_row", "s3_r2", "s3_mask"],
    meta_fields=["n_in", "n_out", "n_src", "n_dst", "Q", "R1", "R3",
                 "chunk_rows"],
)
@dataclass(frozen=True)
class GlobalRoutePlan:
    s1_r1: jax.Array  # [n_src, CR, 128] i8
    s1_src: Optional[jax.Array]  # [n_src, H_o, 128, 128] i8 (None: CR=128)
    s1_row: jax.Array  # [n_src, H_o, 128, 128] i8
    s1_r2: jax.Array  # [n_src, R1, 128] i8
    s3_r1: jax.Array  # [n_dst, R3, 128] i8
    s3_src: Optional[jax.Array]  # [n_dst, CR/128, 128, 128] i8
    s3_row: jax.Array  # [n_dst, CR/128, 128, 128] i8
    s3_r2: jax.Array  # [n_dst, CR, 128] i8
    s3_mask: jax.Array  # [n_dst, CR, 128] i8
    n_in: int
    n_out: int
    n_src: int
    n_dst: int
    Q: int
    R1: int
    R3: int
    chunk_rows: int  # CR: 128-lane rows per chunk (CR*128 elements)

    def _pad(self, v: jax.Array) -> jax.Array:
        npad = self.n_src * self.chunk_rows * LANES
        if v.shape[0] == npad:
            return v
        if v.shape[0] > npad:
            return v[:npad]
        return jnp.zeros(npad, v.dtype).at[: v.shape[0]].set(v)

    def expand_y1(self, x: jax.Array,
                  mul: Optional[jax.Array] = None) -> jax.Array:
        """Stage 1 only: chunk space -> PRE-exchange quota tensor
        [n_src * R1, 128] (src-chunk major)."""
        n_src = self.n_src
        CR = self.chunk_rows
        x_pad = self._pad(x).reshape(n_src * CR, LANES)
        mul_pad = None if mul is None else self._pad(mul).reshape(
            n_src * CR, LANES
        )
        return _run_route_stage(
            x_pad, self.s1_r1, self.s1_src, self.s1_row, self.s1_r2,
            None, n_src, CR, self.R1, False, mul=mul_pad,
        )

    def expand(self, x: jax.Array,
               mul: Optional[jax.Array] = None) -> jax.Array:
        """Stage 1 + quota exchange: chunk space -> post-transpose quota
        tensor [n_dst * R3, 128] (dst-chunk major). The chunk counts are
        padded so n_dst*Q == R1*128 and n_src*Q == R3*128 EXACTLY — the
        all-to-all is one pure reshape/transpose/reshape, no slice and
        no zero-pad materialization."""
        n_src, n_dst, Q = self.n_src, self.n_dst, self.Q
        y1 = self.expand_y1(x, mul)
        zg = jnp.transpose(
            y1.reshape(n_src, n_dst, Q), (1, 0, 2)
        )
        return zg.reshape(n_dst * self.R3, LANES)

    def reduce(self, zg: jax.Array, sliced: bool = True) -> jax.Array:
        """Stage 3: post-transpose quota tensor -> chunk space (data
        slots populated, everything else zero)."""
        y3 = _run_route_stage(
            zg, self.s3_r1, self.s3_src, self.s3_row, self.s3_r2,
            self.s3_mask, self.n_dst, self.R3, self.chunk_rows, True,
        )
        out = y3.reshape(-1)
        return out[: self.n_out] if sliced else out

    def expand_y1_batch(self, x_b: jax.Array,
                        mul: Optional[jax.Array] = None) -> jax.Array:
        """Batched `expand_y1`: x_b [B, n] -> [B, n_src*R1, 128].
        `mul` stays shared across replicates."""
        B = x_b.shape[0]
        n_src, CR = self.n_src, self.chunk_rows
        x_pad = jax.vmap(self._pad)(x_b).reshape(B, n_src * CR, LANES)
        mul_pad = None if mul is None else self._pad(mul).reshape(
            n_src * CR, LANES
        )
        return _run_route_stage(
            x_pad, self.s1_r1, self.s1_src, self.s1_row, self.s1_r2,
            None, n_src, CR, self.R1, False, mul=mul_pad, B=B,
        )

    def reduce_strided_batch(self, y1_b: jax.Array,
                             sliced: bool = True) -> jax.Array:
        """Batched `reduce_strided`: y1_b [B, n_src*R1, 128] ->
        [B, n_pad_out] (tail past n_out is zero)."""
        assert self.Q % LANES == 0, "strided exchange needs Q % 128 == 0"
        B = y1_b.shape[0]
        qr = self.Q // LANES
        y3 = _run_route_stage(
            y1_b.reshape(B, self.n_src, self.n_dst, qr, LANES),
            self.s3_r1, self.s3_src, self.s3_row, self.s3_r2,
            self.s3_mask, self.n_dst, self.R3, self.chunk_rows, True,
            strided_qr=qr, B=B,
        )
        out = y3.reshape(B, -1)
        return out[:, : self.n_out] if sliced else out

    def reduce_strided(self, y1: jax.Array,
                       sliced: bool = True) -> jax.Array:
        """Stage 3 consuming the PRE-exchange quota tensor
        [n_src * R1, 128] directly: each dst chunk reads its Qr-row
        column slab from every source chunk. Requires Q % 128 == 0, so
        the slab is whole 128-lane rows; its layout is then
        bit-identical to the post-transpose chunk, and the stage tables
        apply unchanged."""
        assert self.Q % LANES == 0, "strided exchange needs Q % 128 == 0"
        qr = self.Q // LANES
        y3 = _run_route_stage(
            y1.reshape(self.n_src, self.n_dst, qr, LANES),
            self.s3_r1, self.s3_src, self.s3_row, self.s3_r2,
            self.s3_mask, self.n_dst, self.R3, self.chunk_rows, True,
            strided_qr=qr,
        )
        out = y3.reshape(-1)
        return out[: self.n_out] if sliced else out

    def __call__(self, x: jax.Array, mul: Optional[jax.Array] = None,
                 sliced: bool = True) -> jax.Array:
        """Route `x` (elementwise-multiplied by `mul` in the expand
        stage when given).
        With `sliced=False` the full padded output is returned (the tail
        past `n_out` is zero); callers that index absolute slot ranges
        can skip the slice copy."""
        return self.reduce(self.expand(x, mul), sliced=sliced)


class GlobalRoute:
    """out[out_idx[k]] = x[in_idx[k]] for a static partial injective map
    over [0, n_pad); all other outputs are ZERO. No pad routing, no
    bijection completion: quota slots not covered by data carry garbage
    that is never read back, and output pads are zeroed by a static
    mask. Use `.plan` (a pytree) inside jitted code.

    `chunk_rows` sets the route-chunk size (chunk_rows*128 elements).
    Larger chunks average the per-(src,dst) flows toward their mean
    (Poisson concentration: the quota Q must cover the MAX flow, and at
    chunk=16384 the max sits ~3x above the mean at A=6M), shrinking the
    quota tensor — at the cost of larger per-chunk stage gathers."""

    def __init__(self, out_idx: np.ndarray, in_idx: np.ndarray, n_pad: int,
                 n_out: Optional[int] = None,
                 force_geometry: Optional[Tuple[int, ...]] = None,
                 chunk_rows: int = LANES,
                 n_pad_out: Optional[int] = None,
                 _defer: bool = False):
        out_idx = np.asarray(out_idx, dtype=np.int64)
        in_idx = np.asarray(in_idx, dtype=np.int64)
        CR = int(chunk_rows)
        assert CR % LANES == 0
        CHR = CR * LANES  # elements per chunk
        assert n_pad % CHR == 0, (n_pad, CHR)
        if n_pad_out is None:
            n_pad_out = n_pad
        assert n_pad_out % CHR == 0, (n_pad_out, CHR)
        n_ch = n_pad // CHR
        n_ch_out = n_pad_out // CHR
        maxflow = route_maxflow(out_idx, in_idx, n_pad, chunk=CHR,
                                n_pad_out=n_pad_out)
        if force_geometry is not None:
            # shared geometry across shard-uniform plans (sharded v4):
            # every shard's routing arrays must have identical shapes.
            # (npd, Q) for square plans; (n_src, n_dst, Q) rectangular.
            if len(force_geometry) == 2:
                npd, Q = force_geometry
                n_src = n_dst = npd
            else:
                n_src, n_dst, Q = force_geometry
            assert n_src >= n_ch and n_dst >= n_ch_out and Q >= maxflow, (
                n_src, n_dst, Q, n_ch, n_ch_out, maxflow
            )
            assert n_src * Q % (LANES * LANES) == 0
            assert n_dst * Q % (LANES * LANES) == 0
        else:
            assert n_pad_out == n_pad, (
                "rectangular routes require force_geometry"
            )
            npd, Q = select_route_geometry(n_ch, maxflow)
            n_src = n_dst = npd
        R1 = n_dst * Q // LANES  # stage-1 quota rows per chunk
        R3 = n_src * Q // LANES
        assert R1 % LANES == 0 and R3 % LANES == 0
        if max(R1, R3) // LANES > 16:
            raise ValueError(
                f"GlobalRoute degenerate: H={max(R1, R3) // LANES} "
                f"(Q={Q}, n_chunks={n_src}); use a plain gather instead"
            )
        self.n_in = n_pad
        self.n_out = n_out if n_out is not None else n_pad_out
        self.n_src, self.n_dst, self.Q = n_src, n_dst, Q
        self.R1, self.R3 = R1, R3
        self.chunk_rows = CR

        H_in_gt1 = CR > LANES
        # all 9 tables are carved as views from ONE contiguous slab so
        # the single-transfer device ship (batched_device_tables) can
        # send the slab directly instead of re-concatenating ~GBs of
        # int8 (the concat was ~3s of the 5M cold routes.join)
        shapes = [
            (n_src, CR, LANES),
            (n_src, R1 // LANES, LANES, LANES) if H_in_gt1 else None,
            (n_src, R1 // LANES, LANES, LANES),
            (n_src, R1, LANES),
            (n_dst, R3, LANES),
            (n_dst, CR // LANES, LANES, LANES),
            (n_dst, CR // LANES, LANES, LANES),
            (n_dst, CR, LANES),
            (n_dst, CR, LANES),
        ]
        sizes = [0 if s is None else int(np.prod(s)) for s in shapes]
        self._slab = np.zeros(sum(sizes), dtype=np.int8)
        tables = []
        off = 0
        for s, n in zip(shapes, sizes):
            tables.append(
                None if s is None
                else self._slab[off:off + n].reshape(s)
            )
            off += n
        self._tables = tuple(tables)
        self._out_idx, self._in_idx = out_idx, in_idx
        if not _defer:
            self._fill_tables()
            self._finalize()

    def _fill_tables(self):
        """Populate the nine routing tables (native fast path, NumPy
        fallback). Split out of __init__ so `GlobalRoute.pair` can fill
        a forward/reverse pair with one shared native build."""
        out_idx, in_idx = self._out_idx, self._in_idx
        (s1_r1, s1_src, s1_row, s1_r2,
         s3_r1, s3_src, s3_row, s3_r2, s3_mask) = self._tables
        CR = self.chunk_rows
        CHR = CR * LANES
        n_src, n_dst, Q = self.n_src, self.n_dst, self.Q
        R1, R3 = self.R1, self.R3
        H_in_gt1 = CR > LANES
        d_of = out_idx // CHR
        s_of = in_idx // CHR

        # Fast path: the ENTIRE table build (flow ranks by counting
        # sort, per-chunk 128-edge-coloring on a thread pool, table
        # scatters) in one native call — the NumPy fallback below
        # spends seconds on argsorts and 6M-element index temporaries
        # at the A=6M bench shape.
        if not route_tables_native(
            out_idx, in_idx, CR, n_src, n_dst, Q,
            (s1_r1, s1_src, s1_row, s1_r2,
             s3_r1, s3_src, s3_row, s3_r2, s3_mask),
        ):
            # rank within each (s,d) flow (stable argsort on the
            # combined key == lexsort by (s_of, d_of, position))
            E = len(out_idx)
            order = np.argsort(s_of * n_dst + d_of, kind="stable")
            sd = s_of[order] * n_dst + d_of[order]
            starts = np.concatenate(
                [[0], np.nonzero(np.diff(sd))[0] + 1]
            )
            gid = np.zeros(E, dtype=np.int64)
            gid[starts] = 1
            gid = np.cumsum(gid) - 1
            rank = np.zeros(E, dtype=np.int64)
            rank[order] = np.arange(E) - starts[gid]
            q_slot = d_of * Q + rank  # within src chunk quota space
            q3_slot = s_of * Q + rank  # within dst chunk (post-exch.)

            # Batched channel coloring + flat-index table scatters
            # (one advanced-index assignment per table on the raveled
            # array). `order` is already grouped by src chunk, so it
            # is the stage-1 batch order. All flat indices fit int32.
            H1 = R1 // LANES
            sb = np.searchsorted(s_of[order], np.arange(n_src + 1))
            cid = s_of[order].astype(np.int32)
            io = in_idx[order].astype(np.int32)
            in_row = (io % CHR) // LANES
            qo = q_slot[order].astype(np.int32)
            q_row = qo // LANES
            q_rm = q_row % LANES
            c1 = edge_color_batch(in_row, q_row, sb, max(CR, R1), LANES)
            s1_r1.reshape(-1)[
                (cid * CR + in_row) * LANES + c1
            ] = io % LANES
            mid1 = (
                (cid * H1 + q_row // LANES) * LANES + c1
            ) * LANES + q_rm
            if H_in_gt1:
                s1_src.reshape(-1)[mid1] = in_row // LANES
            s1_row.reshape(-1)[mid1] = in_row % LANES
            s1_r2.reshape(-1)[
                (cid * R1 + q_row) * LANES + qo % LANES
            ] = c1

            H3 = CR // LANES
            do = np.argsort(d_of, kind="stable")
            db = np.searchsorted(d_of[do], np.arange(n_dst + 1))
            did = d_of[do].astype(np.int32)
            q3o = q3_slot[do].astype(np.int32)
            q3_row = q3o // LANES
            oo = out_idx[do].astype(np.int32)
            o_row = (oo % CHR) // LANES
            o_flat = (did * CR + o_row) * LANES + oo % LANES
            c3 = edge_color_batch(q3_row, o_row, db, max(R3, CR), LANES)
            s3_r1.reshape(-1)[
                (did * R3 + q3_row) * LANES + c3
            ] = q3o % LANES
            mid3 = (
                ((did * H3 + o_row // LANES) * LANES + c3) * LANES
                + o_row % LANES
            )
            s3_src.reshape(-1)[mid3] = q3_row // LANES
            s3_row.reshape(-1)[mid3] = q3_row % LANES
            s3_r2.reshape(-1)[o_flat] = c3
            s3_mask.reshape(-1)[o_flat] = 1

    def _finalize(self, dev_tables=None):
        (s1_r1, s1_src, s1_row, s1_r2,
         s3_r1, s3_src, s3_row, s3_r2, s3_mask) = self._tables
        n_src, n_dst, Q = self.n_src, self.n_dst, self.Q
        R1, R3, CR = self.R1, self.R3, self.chunk_rows
        slab = self._slab
        del self._tables, self._slab, self._out_idx, self._in_idx
        if dev_tables is None:
            (dev_tables,) = batched_device_tables(
                [[s1_r1, s1_src, s1_row, s1_r2,
                  s3_r1, s3_src, s3_row, s3_r2, s3_mask]],
                slabs=[slab],
            )
        (s1_r1, s1_src, s1_row, s1_r2,
         s3_r1, s3_src, s3_row, s3_r2, s3_mask) = dev_tables
        self.plan = GlobalRoutePlan(
            s1_r1=s1_r1,
            s1_src=s1_src,
            s1_row=s1_row,
            s1_r2=s1_r2,
            s3_r1=s3_r1,
            s3_src=s3_src,
            s3_row=s3_row,
            s3_r2=s3_r2,
            s3_mask=s3_mask,
            n_in=self.n_in,
            n_out=self.n_out,
            n_src=n_src,
            n_dst=n_dst,
            Q=Q,
            R1=R1,
            R3=R3,
            chunk_rows=CR,
        )

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.plan(x)


def build_route_pair(
    out_idx: np.ndarray,
    in_idx: np.ndarray,
    n_pad: int,
    force_geometry: Optional[Tuple[int, ...]] = None,
    chunk_rows: int = LANES,
    n_pad_out: Optional[int] = None,
) -> Tuple[GlobalRoutePlan, GlobalRoutePlan]:
    """Build the forward route (out_idx <- in_idx) AND its reverse
    (in_idx <- out_idx) with ONE shared native table build. The reverse
    route's per-chunk channel graphs are the forward's with edge
    direction flipped (identical flows and ranks), so each chunk side is
    edge-colored once instead of twice — the colorings dominate the
    table-build cost (~2.1 s per route at the A=6M bench shape on 4
    cores). Returns (fwd.plan, rev.plan); falls back to two independent
    builds when the native pair entry point is unavailable."""
    handle = build_route_pair_async(
        out_idx, in_idx, n_pad, force_geometry=force_geometry,
        chunk_rows=chunk_rows, n_pad_out=n_pad_out,
    )
    return handle()


def build_route_pair_async(
    out_idx: np.ndarray,
    in_idx: np.ndarray,
    n_pad: int,
    force_geometry: Optional[Tuple[int, ...]] = None,
    chunk_rows: int = LANES,
    n_pad_out: Optional[int] = None,
    keep_host: bool = False,
):
    """`build_route_pair` with the heavy table fill running on a worker
    thread (the native entry point releases the GIL and runs its own
    pool). Geometry is resolved EAGERLY — `handle.n_src/.n_dst/.Q/
    .chunk_rows` are valid immediately — so the caller can build and
    device-transfer everything geometry-dependent (w_txp, seg_id)
    concurrently with the coloring. Call the handle to join and get
    (fwd.plan, rev.plan). With `keep_host=True` the host-side tables
    survive as `handle.host` (for the persistent plan cache)."""
    import threading

    from .permute_plan import route_tables_pair_native

    fwd = GlobalRoute(out_idx, in_idx, n_pad,
                      force_geometry=force_geometry,
                      chunk_rows=chunk_rows, n_pad_out=n_pad_out,
                      _defer=True)
    n_pad_fwd_out = n_pad if n_pad_out is None else n_pad_out
    rev = GlobalRoute(in_idx, out_idx, n_pad_fwd_out,
                      force_geometry=(fwd.n_dst, fwd.n_src, fwd.Q),
                      chunk_rows=chunk_rows, n_pad_out=n_pad,
                      _defer=True)
    state = {}

    def fill():
        try:
            if not route_tables_pair_native(
                out_idx, in_idx, chunk_rows, fwd.n_src, fwd.n_dst, fwd.Q,
                fwd._tables, rev._tables,
            ):
                fwd._fill_tables()
                rev._fill_tables()
        except BaseException as e:  # noqa: BLE001 — re-raised at join
            state["err"] = e

    th = threading.Thread(target=fill, daemon=True)
    th.start()

    def handle():
        th.join()
        if "err" in state:
            raise state["err"]
        if keep_host:
            handle.host = tuple(
                {
                    "tables": r._tables,
                    "meta": (r.n_in, r.n_out, r.n_src, r.n_dst, r.Q,
                             r.R1, r.R3, r.chunk_rows),
                }
                for r in (fwd, rev)
            )
        devs = batched_device_tables(
            [fwd._tables, rev._tables], slabs=[fwd._slab, rev._slab]
        )
        fwd._finalize(dev_tables=devs[0])
        rev._finalize(dev_tables=devs[1])
        return fwd.plan, rev.plan

    handle.n_src, handle.n_dst = fwd.n_src, fwd.n_dst
    handle.Q, handle.chunk_rows = fwd.Q, fwd.chunk_rows
    return handle

