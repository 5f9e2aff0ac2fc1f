"""EM v4: the dual-bucketed, fully-static-routed iteration.

v4 makes BOTH reductions of the iteration (per-read denominators and
per-transcript sums) dense row sums over bucketed layouts and connects
them with two static permutations:

  prev[T] --tiny tile permute--> per-transcript-row values
          --row broadcast--> prev_slots ; contrib_t = prev_slots * w_txp
  contrib_t --P_A--> read-bucket layout
  read-row sums -> denom -> scale -> row broadcast
  inc = contrib_read * scale_slots
  inc --P_B--> transcript-bucket layout
  txp-row sums (+ second level for chunked hot transcripts)
          --tiny tile permute--> curr[T]

No gathers, no scatters, no cumsums over the alignment space: the whole
iteration is row reductions, broadcasts, elementwise products, and four
static permutation networks (`static_permute`).

Layout: buckets are stored COLUMN-MAJOR within groups of 128 rows — the
slot of (row i, position j) is `start + (i//128)*K*128 + j*128 + i%128`
— so every reduction and broadcast is over a `[groups, K, 128]` view
whose minor dimension is exactly the 128-lane vector width. (The naive
`[rows, K]` view forces XLA to lane-pad the minor dimension: a
`[rows, 1]` intermediate materializes at 128x its logical size.) Row
counts
are padded to multiples of 128 with all-zero rows.

Transcripts with more than CAPK alignments are chunked over consecutive
CAPK-wide rows and their row sums reduced in a tiny static second
level, keeping the bucket padding ~10% instead of the up-to-2x of pure
power-of-two rounding.

Semantics match the reference serial EM (`em.rs:87-255`) exactly as
`em_fast` does; parity is tested against the NumPy oracle and a NumPy
routing simulation (`tests/test_static_routing.py`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import EM_DENOM_THRESH, MIN_READ_THRESH
from .em_fast import _rel_diff
from .static_permute import (
    CH,
    LANES,
    BatchTilePermute,
    DeviceTilePlan,
    _run_middle_stage,
)

CAPK = 2048  # max bucket row width; wider transcripts are row-chunked


def _pad128(n: int) -> int:
    return ((n + LANES - 1) // LANES) * LANES


def _pow2_buckets(sizes: np.ndarray, shuffle_rng, buckets=None,
                  align_groups: bool = False):
    """Group rows (reads or transcripts) by power-of-two size buckets
    (bucket K holds sizes in (K//2, K]). Returns
    (shapes, starts, row_parts, n_slots): shapes hold the 128-PADDED row
    count per bucket; row_parts the true member ids (shuffled within
    buckets — flow decorrelation). Size-0 rows are excluded.

    With `align_groups` each bucket start is aligned to K*128 (its own
    group span), so no 128-row group ever straddles a route-chunk
    boundary — the invariant the fused middle stage's in-chunk row
    sums rely on (read side only; total waste < sum K*128 ~ tens of KB).

    With `buckets` (a ((K, rows_pad), ...) envelope from a shard-uniform
    build, see `merge_envelopes`) the bucket list and padded row counts
    are forced — possibly larger than this dataset needs; the extra rows
    are dead (their slots stay all-zero)."""
    if buckets is None:
        maxk = int(sizes.max()) if len(sizes) else 1
        ks: List[int] = []
        K = 1
        while K < maxk:
            ks.append(K)
            K *= 2
        ks.append(max(K, 1))
        buckets = []
        lo = 0
        for K in ks:
            n = int(np.count_nonzero((sizes > lo) & (sizes <= K)))
            lo = K
            if n:
                buckets.append((K, _pad128(n)))
    shapes = []
    starts = []
    row_parts = []
    n_slots = 0
    for K, rows_pad in buckets:
        lo = K // 2
        rows = np.nonzero((sizes > lo) & (sizes <= K))[0]
        assert _pad128(len(rows)) <= rows_pad
        rows = shuffle_rng.permutation(rows)
        if align_groups:
            span = K * LANES
            n_slots = ((n_slots + span - 1) // span) * span
        starts.append(n_slots)
        shapes.append((int(rows_pad), int(K)))
        row_parts.append(rows)
        n_slots += rows_pad * K
    return shapes, starts, row_parts, n_slots


_POW2 = 1 << np.arange(63, dtype=np.int64)


def _pow2_buckets_pre(class_rows, max_size, shuffle_rng, buckets=None,
                      align_groups: bool = False):
    """`_pow2_buckets` from prebuilt per-class member lists (ascending
    ids — the chunk-incremental path). Mirrors `_pow2_buckets` exactly,
    including rng consumption order, so the resulting layout is
    bit-identical to the monolithic build (differential-tested in
    tests/test_static_routing.py)."""
    if buckets is None:
        maxk = max(int(max_size), 1)
        ks: List[int] = []
        K = 1
        while K < maxk:
            ks.append(K)
            K *= 2
        ks.append(max(K, 1))
        buckets = [
            (K, _pad128(len(class_rows[K])))
            for K in ks
            if len(class_rows.get(K, ())) > 0
        ]
    shapes = []
    starts = []
    row_parts = []
    n_slots = 0
    empty = np.empty(0, dtype=np.int64)
    for K, rows_pad in buckets:
        rows = class_rows.get(K, empty)
        assert _pad128(len(rows)) <= rows_pad
        rows = shuffle_rng.permutation(rows)
        if align_groups:
            span = K * LANES
            n_slots = ((n_slots + span - 1) // span) * span
        starts.append(n_slots)
        shapes.append((int(rows_pad), int(K)))
        row_parts.append(rows)
        n_slots += rows_pad * K
    return shapes, starts, row_parts, n_slots


class V4Prebuild:
    """Chunk-incremental precomputation of the v4 layout's A-sized
    inputs, overlapped with the streaming pack (the reference's
    producer→consumer ingest shape, `bulk.rs:364-682`, extended to the
    routing build the reference doesn't have).

    As filtered CSR chunks land (`host/packer.py` `chunk_observer`), a
    worker thread accumulates, off the post-pack critical path:
      - per-transcript alignment counts (running bincount),
      - each alignment's global rank within its transcript
        (chunk-local counting-sort rank + the running prefix count),
      - read power-of-two size-class member lists (class of a read is
        final when its chunk lands — groups never straddle chunks).
    `_v4_layout(pre=...)` then skips its own `rank`/`read_buckets`/
    `bincount` passes and reconstructs `ord2` with one scatter. The
    results are bit-identical to the monolithic path."""

    def __init__(self, queue_depth: int = 8):
        import queue as _queue
        import threading as _threading

        self.counts = np.zeros(1024, dtype=np.int64)
        self.rank_chunks: List[np.ndarray] = []
        self.class_rows: dict = {}
        self.read_off = 0
        self.aln_off = 0
        self.max_size = 0
        self._err: Optional[BaseException] = None
        self._quiet = False
        self._q: "_queue.Queue" = _queue.Queue(maxsize=queue_depth)
        self._th = _threading.Thread(target=self._run, daemon=True)
        self._th.start()

    # -- producer side (pack consumer thread)
    def observe(self, packed) -> None:
        if self._err is None:
            self._q.put((packed.txp_id, np.diff(packed.boundaries)))

    # -- worker
    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                continue  # drain
            try:
                self._ingest(*item)
            except BaseException as e:  # noqa: BLE001 — falls back
                self._err = e

    def _ingest(self, txp_id: np.ndarray, sizes: np.ndarray) -> None:
        from . import balance as _balance

        t64 = np.ascontiguousarray(txp_id, dtype=np.int64)
        if len(t64):
            tmax = int(t64.max())
            if tmax >= len(self.counts):
                grown = np.zeros(
                    max(tmax + 1, 2 * len(self.counts)), dtype=np.int64
                )
                grown[: len(self.counts)] = self.counts
                self.counts = grown
            rk = _balance.rank_by_key(t64, len(self.counts))
            if rk is not None:
                local_rank = rk[1]
            else:
                ordc = np.argsort(t64, kind="stable")
                cc = np.bincount(t64, minlength=len(self.counts))
                rs = np.zeros(len(cc) + 1, dtype=np.int64)
                np.cumsum(cc, out=rs[1:])
                lr = np.arange(len(t64), dtype=np.int64) - rs[t64[ordc]]
                local_rank = np.empty(len(t64), dtype=np.int64)
                local_rank[ordc] = lr
            self.rank_chunks.append(local_rank + self.counts[t64])
            self.counts[: tmax + 1] += np.bincount(t64, minlength=tmax + 1)
        sizes = np.asarray(sizes, dtype=np.int64)
        if len(sizes):
            self.max_size = max(self.max_size, int(sizes.max()))
            cls = np.searchsorted(_POW2, sizes, side="left")
            for c in np.unique(cls):
                K = int(_POW2[c])
                ids = self.read_off + np.nonzero(cls == c)[0]
                self.class_rows.setdefault(K, []).append(ids)
        self.read_off += len(sizes)
        self.aln_off += len(t64)

    def finish(self, num_txps: int) -> Optional[dict]:
        """Join the worker and assemble the layout inputs; None when
        ingestion failed (the caller builds monolithically)."""
        self._q.put(None)
        self._th.join()
        if self._err is not None:
            if not self._quiet:
                import logging

                logging.getLogger("oarfish_tpu").warning(
                    "v4 prebuild failed (%s); building monolithically",
                    self._err,
                )
            return None
        if len(self.counts) < num_txps:
            grown = np.zeros(num_txps, dtype=np.int64)
            grown[: len(self.counts)] = self.counts
            self.counts = grown
        empty = np.empty(0, dtype=np.int64)
        return {
            "counts": self.counts[:num_txps],
            "rank": (
                np.concatenate(self.rank_chunks)
                if self.rank_chunks
                else empty
            ),
            "classes": {
                K: np.concatenate(parts)
                for K, parts in self.class_rows.items()
            },
            "max_size": self.max_size,
            "A": self.aln_off,
            "R": self.read_off,
        }

    def abort(self, quiet: bool = False) -> None:
        self._quiet = self._quiet or quiet
        self._err = self._err or RuntimeError("aborted")
        try:
            self._q.put_nowait(None)
        except Exception:  # noqa: BLE001
            pass


def compute_envelope(txp_id, boundaries, num_txps) -> dict:
    """Static-shape requirements of this dataset's v4 layout. Merging
    envelopes across read shards (`merge_envelopes`) and passing the
    result to every shard's build yields EmV4Data pytrees with IDENTICAL
    treedefs/shapes — the precondition for stacking them as `shard_map`
    data (parallel/sharded_v4.py)."""
    sizes = np.diff(np.asarray(boundaries, dtype=np.int64))
    counts = np.bincount(
        np.asarray(txp_id, dtype=np.int64), minlength=num_txps
    )

    def ladder(szs):
        maxk = int(szs.max()) if len(szs) else 1
        out = []
        K = 1
        lo = 0
        while True:
            n = int(np.count_nonzero((szs > lo) & (szs <= K)))
            if n:
                out.append((K, _pad128(n)))
            if K >= maxk:
                break
            lo = K
            K *= 2
        return tuple(out)

    read_buckets = ladder(sizes)
    small = np.where((counts > 0) & (counts <= CAPK), counts, 0)
    small_buckets = ladder(small) if small.any() else ()
    big = counts[counts > CAPK]
    n_big = int(len(big))
    big_rows = int(np.ceil(big / CAPK).sum()) if n_big else 0
    row_space_s = sum(rp for _, rp in small_buckets)
    t_rows = _tile_rows(max(num_txps, row_space_s + n_big, 1))
    return {
        "read_buckets": read_buckets,
        "small_buckets": small_buckets,
        "big_rows_pad": _pad128(big_rows),
        "n_big": n_big,
        "t_rows": t_rows,
    }


def _quant_up(n: int) -> int:
    """Round up to the next 1/8-mantissa quantum (m * 2^e, m in
    [9, 16]); values <= 16 are exact. Bounded waste (< 12.5%), coarse
    enough that nearby values collapse to one quantum."""
    n = int(n)
    if n <= 16:
        return n
    e = (n - 1).bit_length() - 4
    step = 1 << e
    return -(-n // step) * step


def canonical_envelope(env: dict) -> dict:
    """Quantize a dataset's natural envelope onto canonical shape
    quanta so DIFFERENT datasets of similar scale produce IDENTICAL
    EmV4Data shapes/meta — and therefore identical EM-loop HLO (the
    loop itself is T-free, see make_runner), so the persistent XLA
    compile cache serves the FIRST run of new data (VERDICT r3 item
    1b). Buckets get a full K ladder (reads to >= 128, transcripts to
    CAPK) with 1/8-mantissa-quantized padded row counts (empty forced
    buckets cost 128 inert rows each); big-region and tile-permute
    spaces are quantized the same way. Waste is bounded at ~7-12%% of
    slot space; a pad row's slots stay all-zero (inert)."""

    import os as _os

    # headroom above the dataset's natural row counts. Default 1.0: the
    # 1/8-mantissa quanta already absorb small jitter, and extra rows
    # can cross 128-flow quota boundaries (a superlinear tax on every
    # iteration). A later, slightly bigger dataset grows the class (ONE
    # extra sticky compile) instead of taxing every iteration.
    H = float(_os.environ.get("OARFISH_CANON_HEADROOM", "1.0"))
    full_ladder = _os.environ.get("OARFISH_CANON_LADDER", "1") != "0"

    def canon_buckets(buckets, ladder_to):
        have = dict((int(K), int(rp)) for K, rp in buckets)
        maxk = max(list(have) + ([ladder_to] if full_ladder else []))
        out = []
        K = 1
        while K <= maxk:
            if not full_ladder and K not in have and K != maxk:
                K *= 2
                continue
            rows128 = max(int(np.ceil(have.get(K, 0) * H / LANES)), 1)
            out.append((K, _quant_up(rows128) * LANES))
            K *= 2
        return tuple(out)

    big128 = max(int(np.ceil(env["big_rows_pad"] * H / LANES)), 1)
    t128 = int(np.ceil(env["t_rows"] * H / LANES))
    return {
        "read_buckets": canon_buckets(env["read_buckets"], 128),
        "small_buckets": canon_buckets(env["small_buckets"], CAPK),
        "big_rows_pad": _quant_up(big128) * LANES,
        "n_big": max(_quant_up(int(np.ceil(env["n_big"] * H)) + 1), 1),
        "t_rows": _quant_up(t128) * LANES,
    }


def merge_envelopes(envs: List[dict]) -> dict:
    """Pointwise max of per-shard envelopes (union of bucket Ks, max
    padded rows per K)."""

    def merge_buckets(key):
        acc = {}
        for e in envs:
            for K, rp in e[key]:
                acc[K] = max(acc.get(K, 0), rp)
        return tuple(sorted(acc.items()))

    return {
        "read_buckets": merge_buckets("read_buckets"),
        "small_buckets": merge_buckets("small_buckets"),
        "big_rows_pad": max(e["big_rows_pad"] for e in envs),
        "n_big": max(e["n_big"] for e in envs),
        "t_rows": max(e["t_rows"] for e in envs),
    }


def _colmajor_slot(start: int, K: int, row, col):
    """Flat slot of (bucket row, position) in the column-major layout."""
    return start + (row >> 7) * (K << 7) + (col << 7) + (row & 127)


def _tile_rows(n: int) -> int:
    """Smallest row count (multiple of 128) whose [rows,128] tile holds n."""
    rows = (n + LANES - 1) // LANES
    return ((rows + LANES - 1) // LANES) * LANES


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["w_txp", "p_a", "p_b", "t_in", "t_out", "big_row_of_txp",
                 "big_row_offsets", "seg_id"],
    meta_fields=["read_shapes", "read_starts", "n_slots_r", "row_space_r",
                 "small_shapes", "small_starts", "row_space_s",
                 "big_rows_pad", "n_big", "n_slots_t", "t_space",
                 "num_reads", "num_txps"],
)
@dataclass(frozen=True)
class EmV4Data:
    """Static device state for the dual-bucketed EM (a pytree; all large
    routing arrays travel as jit arguments)."""

    w_txp: jax.Array  # [n_slots_t] weights in txp-bucket layout (pads 0)
    p_a: object  # GlobalRoutePlan: txp layout -> read layout
    p_b: object  # GlobalRoutePlan: read layout -> txp layout
    t_in: object  # BatchTilePermute: prev[T] -> per-row / per-big values
    t_out: object  # BatchTilePermute: row sums -> curr[T]
    big_row_of_txp: jax.Array  # [big_rows_pad] i32: big-txp idx per row
    big_row_offsets: jax.Array  # [n_big+1] i32 row ranges per big txp
    seg_id: Optional[jax.Array]  # [n_chunks*CR, 128] i8 log2(K) per row
    read_shapes: Tuple[Tuple[int, int], ...]  # (rows_pad, K)
    read_starts: Tuple[int, ...]
    n_slots_r: int
    row_space_r: int
    small_shapes: Tuple[Tuple[int, int], ...]
    small_starts: Tuple[int, ...]
    row_space_s: int
    big_rows_pad: int
    n_big: int
    n_slots_t: int
    t_space: int
    num_reads: int
    num_txps: int

    @staticmethod
    def build(
        txp_id: np.ndarray,
        weights: np.ndarray,
        boundaries: np.ndarray,
        num_txps: int,
        debug: bool = False,
        envelope: Optional[dict] = None,
        geometry: Optional[Tuple[int, int]] = None,
        pre: Optional[dict] = None,
        prefetch=None,
        pointer_key: Optional[str] = None,
    ):
        """Build the routed device state. `envelope` (see
        `compute_envelope`/`merge_envelopes`) forces the bucket/t-space
        static shapes and `geometry` the route (chunk-pad, Q) — both are
        required to be shard-uniform for the sharded v4 path. `pre`
        (from `V4Prebuild.finish`) supplies the A-sized layout inputs
        precomputed during the streaming pack.

        Single-shard non-debug builds consult the persistent plan cache
        (ops/plan_cache.py): the layout + route tables depend only on
        the CSR structure, so re-quantifying the same alignments skips
        the whole build (weights re-enter via one w_txp scatter)."""
        import logging as _logging
        import os as _os

        from . import plan_cache

        _plog = _logging.getLogger("oarfish_tpu")
        cache_key = None
        if (
            not debug and envelope is None and geometry is None
            and plan_cache.enabled()
        ):
            cache_key = plan_cache.layout_key(txp_id, boundaries, num_txps)
            if prefetch is not None:
                got = prefetch.finish(
                    cache_key, np.asarray(weights, dtype=np.float64)
                )
                if got is not None:
                    _plog.info(
                        "v4 plan prefetch hit (%s…): route build and "
                        "table transfers overlapped the pack",
                        cache_key[:12],
                    )
                    if pointer_key is not None:
                        plan_cache.write_pointer(pointer_key, cache_key)
                    return got
            hit = plan_cache.load(cache_key)
            if hit is not None:
                try:
                    out = plan_cache.finish_from_cache(
                        hit, np.asarray(weights, dtype=np.float64)
                    )
                    _plog.info(
                        "v4 plan cache hit (%s…): route build skipped",
                        cache_key[:12],
                    )
                    if pointer_key is not None:
                        plan_cache.write_pointer(pointer_key, cache_key)
                    return out
                except Exception as e:  # noqa: BLE001 — treat as miss
                    _plog.warning(
                        "v4 plan cache entry unusable (%s); rebuilding", e
                    )

        # Canonical shapes for single-shard big builds: the envelope is
        # quantized onto coarse quanta and the route geometry likewise
        # (in _v4_finish), so similar-scale datasets compile to the
        # SAME EM program and the persistent XLA cache serves first
        # runs. Deterministic from the CSR, so plan-cache entries stay
        # valid. OARFISH_CANONICAL=0 disables; _MIN sets the A floor.
        canonical = (
            envelope is None and geometry is None and not debug
            and _os.environ.get("OARFISH_CANONICAL", "1") != "0"
            and len(txp_id) >= int(_os.environ.get(
                "OARFISH_CANONICAL_MIN", "1000000"))
        )
        canon_rec = None
        canon_key = None
        if canonical:
            # sticky shape class: the first dataset of a scale class
            # defines the canonical envelope (its natural shapes,
            # quantized up); later similar-scale datasets that FIT
            # reuse it verbatim — identical shapes => identical EM HLO
            # => persistent-compile-cache hit on their FIRST run.
            nat = compute_envelope(txp_id, boundaries, num_txps)
            canon_key = plan_cache.env_class_key(len(txp_id))
            # probe the neighbor classes too: a dataset sitting at a
            # sqrt(2) class boundary should still reuse the adjacent
            # class's envelope rather than founding a near-duplicate
            canon_rec = None
            own = canonical_envelope(nat)
            for k in plan_cache.env_class_neighbors(canon_key):
                rec = plan_cache.load_env_class(k)
                if rec is not None and plan_cache.env_fits(
                    nat, rec["env"], ref=own
                ):
                    canon_rec = rec
                    canon_key = k
                    break
            if canon_rec is not None:
                envelope = canon_rec["env"]
                _plog.info(
                    "canonical envelope class %s fits; shapes shared "
                    "with prior datasets of this scale", canon_key,
                )
            else:
                # grow the class monotonically (merge keeps every
                # previously-fitting dataset fitting) unless the stored
                # record is pathologically oversized for this dataset —
                # then build for ourselves and leave the record alone
                base = plan_cache.load_env_class(canon_key)
                merged = (
                    merge_envelopes([own, base["env"]])
                    if base is not None else own
                )
                if plan_cache.env_slots(merged) <= 1.35 * max(
                    plan_cache.env_slots(own), 1
                ):
                    envelope = merged
                else:
                    envelope = own
                    canon_key = None  # do not clobber the class record
                canon_rec = None  # geometry must be (re)derived
        lay = _v4_layout(txp_id, weights, boundaries, num_txps, envelope,
                         pre=pre, canonical=canonical)
        if canonical:
            lay["canon"] = (canon_key, envelope, canon_rec)
        # rect rebuild is OPT-IN (scripts/rect_ab_bench.py): the halved
        # quota must pay for the 1.5x larger read space the
        # row-sum/expand stages traverse.
        if (
            envelope is None
            and geometry is None
            and _os.environ.get("OARFISH_RECT") == "1"
        ):
            lay2 = _try_rect_rebuild(
                txp_id, weights, boundaries, num_txps, lay
            )
            if lay2 is not None:
                lay = lay2
        data = _v4_finish(lay, geometry, cache_key=cache_key,
                          pointer_key=pointer_key, canonical=canonical)
        if debug:
            return data, lay["read_order"], lay["dbg"]
        return data, lay["read_order"]


def _v4_layout(
    txp_id: np.ndarray,
    weights: np.ndarray,
    boundaries: np.ndarray,
    num_txps: int,
    envelope: Optional[dict] = None,
    rect_hint: Optional[Tuple[int, int, int, int]] = None,
    pre: Optional[dict] = None,
    canonical: bool = False,
) -> dict:
    """Phase 1 of the v4 build: bucket layouts, slot maps, and the tiny
    T-space tile permutes — everything except the two GlobalRoutes (whose
    geometry a shard-uniform build must choose from ALL shards' flows;
    see `route_maxflow`/`select_route_geometry`).

    Row placement within buckets is flow-balanced (ops/balance.py) when
    the native placer is available: reads and small transcripts are
    greedily assigned to the bucket row whose chunk minimizes the
    running max (txp-chunk, read-chunk) cell load, pulling the route
    quota Q toward the mean flow (random placement leaves it 2-3x
    higher). Rows not chosen stay pads (all-zero slots, inert)."""
    import os as _os
    import time as _time

    _phases: List[Tuple[str, float]] = []
    _t_last = [_time.perf_counter()]

    def _tick(label: str) -> None:
        now = _time.perf_counter()
        _phases.append((label, now - _t_last[0]))
        _t_last[0] = now

    txp_id = np.asarray(txp_id, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float64)
    boundaries = np.asarray(boundaries, dtype=np.int64)
    R = len(boundaries) - 1
    A = len(txp_id)
    T = int(num_txps)
    sizes = np.diff(boundaries)

    if pre is not None and (
        pre["A"] != A or pre["R"] != R or len(pre["counts"]) != T
    ):
        import logging as _logging

        _logging.getLogger("oarfish_tpu").warning(
            "v4 prebuild shape mismatch (A %d/%d, R %d/%d); building "
            "monolithically", pre["A"], A, pre["R"], R,
        )
        pre = None

    from . import balance as _balance

    use_balance = (
        _os.environ.get("OARFISH_V4_NO_BALANCE") != "1"
        and _balance.available()
    )
    BCH = _balance.BAL_CHR

    # ---- read-side buckets (membership only; rows assigned below)
    rng_r = np.random.default_rng(3)
    if pre is not None:
        read_shapes, read_starts, read_row_parts, n_slots_r = (
            _pow2_buckets_pre(
                pre["classes"], pre["max_size"], rng_r,
                envelope["read_buckets"] if envelope else None,
                align_groups=True,
            )
        )
    else:
        read_shapes, read_starts, read_row_parts, n_slots_r = _pow2_buckets(
            sizes, rng_r,
            envelope["read_buckets"] if envelope else None,
            align_groups=True,
        )
    row_space_r = sum(rp for rp, _ in read_shapes)
    _tick("read_buckets")

    # ---- transcript-side buckets (pow2 up to CAPK, then row-chunked)
    counts = (
        pre["counts"] if pre is not None
        else np.bincount(txp_id, minlength=T)
    )
    rng_t = np.random.default_rng(5)
    small_mask = (counts > 0) & (counts <= CAPK)
    small_sizes = np.where(small_mask, counts, 0)
    env_small = envelope["small_buckets"] if envelope else None
    small_shapes, small_starts, small_row_parts, n_small_slots = (
        _pow2_buckets(small_sizes, rng_t, env_small)
        if (small_mask.any() or env_small)
        else ([], [], [], 0)
    )
    row_space_s = sum(rp for rp, _ in small_shapes)
    _tick("small_buckets")

    big_txps = np.nonzero(counts > CAPK)[0]
    big_txps = rng_t.permutation(big_txps)
    n_big_real = len(big_txps)
    # envelope may force MORE big slots/rows than this dataset has; the
    # dummy entries own no rows and no transcript positions (inert)
    n_big = max(n_big_real, envelope["n_big"]) if envelope else n_big_real
    big_chunks = (
        np.ceil(counts[big_txps] / CAPK).astype(np.int64)
        if n_big_real
        else np.empty(0, np.int64)
    )
    n_big_rows = int(big_chunks.sum())
    # big-region dilution (bp/bq > 1): interleave bp-bq dead rows per bq
    # real rows so fixed big-txp slots don't pack chunks 100% full (a
    # full chunk's row sum is CHR -> per-cell mean CHR/n_dst, which
    # pins the route quota; see _try_dilated_rebuild). Physical row of
    # logical row r is (r//bq)*bp + r%bq; offsets are stored in
    # PHYSICAL units — the m-step's cumsum-difference spans dead rows
    # harmlessly (their slots stay all-zero).
    bp, bq = (envelope.get("big_pq", (1, 1)) if envelope else (1, 1))

    if bp == 1 and bq == 1:
        def _bphys(r):  # identity in the common undiluted case — the
            return r    # div/mod form costs ~0.7s of A-sized passes
    else:
        def _bphys(r):
            return (r // bq) * bp + r % bq

    n_big_rows_phys = int(_bphys(n_big_rows - 1)) + 1 if n_big_rows else 0
    big_rows_pad = _pad128(n_big_rows_phys)
    if envelope:
        big_rows_pad = max(big_rows_pad, envelope["big_rows_pad"])
    big_off_log = np.zeros(n_big + 1, dtype=np.int64)
    np.cumsum(big_chunks, out=big_off_log[1 : n_big_real + 1])
    big_off_log[n_big_real + 1 :] = big_off_log[n_big_real]
    big_row_offsets = _bphys(big_off_log)
    big_row_of_txp = np.zeros(big_rows_pad, dtype=np.int64)
    if n_big_real:
        big_row_of_txp[_bphys(np.arange(n_big_rows))] = np.repeat(
            np.arange(n_big_real), big_chunks
        )
    big_start = n_small_slots
    n_slots_t = n_small_slots + big_rows_pad * CAPK
    _tick("big_tables")

    # Auto layout policy (cold-build tax, VERDICT r3 item 1): the
    # greedy/repair balance machinery exists to pull the max route-cell
    # flow under the next 128 quota boundary. When the MEAN cell flow
    # is far below the 128 legality floor, the buckets' within-bucket
    # shuffle alone already lands max flow < 128 (measured at the 5M e2e
    # shape: identical (npd, Q) geometry with and without balancing,
    # 11.0s vs 6.9s layout+route build; scripts/layout_policy_ab.py),
    # so the ~4s of placement work buys nothing. Skip it when the mean
    # at the usual CR=256 chunking is <= 56 (128 is then >= mean + 6-7
    # sigma even against the big-region's pinned full rows). A miss
    # costs only a larger Q (slower EM iters), never correctness.
    # OARFISH_V4_NO_BALANCE=1 forces fast, =0 forces balanced.
    if (
        use_balance
        and (envelope is None or canonical)
        and _os.environ.get("OARFISH_V4_NO_BALANCE") is None
    ):
        _chr_est = 256 * LANES
        _n_chk_est = max(
            -(-max(n_slots_r, n_slots_t) // _chr_est), 1
        )
        _mean_flow = A / (_n_chk_est * _n_chk_est)
        if _mean_flow <= 56.0:
            use_balance = False
            import logging as _logging

            _logging.getLogger("oarfish_tpu").info(
                "v4 layout: mean cell flow %.1f << Q floor 128; "
                "skipping the balance passes", _mean_flow,
            )

    # per-alignment rank within its transcript (native counting sort;
    # the NumPy form costs an A-sized stable argsort + 4 more passes).
    # With a prebuild, ranks arrived chunk-incrementally during the
    # pack and ord2 is one scatter (rank IS the stable position).
    if pre is not None:
        rank = pre["rank"]
        run_start = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(counts, out=run_start[1:])
        ord2 = np.empty(A, dtype=np.int64)
        ord2[run_start[txp_id] + rank] = np.arange(A, dtype=np.int64)
    else:
        _rk = _balance.rank_by_key(txp_id, T)
        if _rk is not None:
            ord2, rank, run_start = _rk
        else:
            ord2 = np.argsort(txp_id, kind="stable")
            run_start = np.zeros(T + 1, dtype=np.int64)
            np.cumsum(counts, out=run_start[1:])
            rank_sorted = np.arange(A) - run_start[txp_id[ord2]]
            rank = np.zeros(A, dtype=np.int64)
            rank[ord2] = rank_sorted
    _tick("rank")

    # ---- big-transcript slots (fixed contiguous rows; their alignment
    # slots smear across many chunks per group, self-decorrelating)
    txp_slot_of_aln = np.zeros(A, dtype=np.int64)
    small_aln = small_mask[txp_id]
    big_aln = counts[txp_id] > CAPK
    # big-alignment index, computed once: boolean-mask gathers over the
    # A-sized arrays were ~45% of this function's own time at A=6M
    big_idx = np.nonzero(big_aln)[0] if n_big_real else None
    if n_big_real:
        big_index = np.full(T, -1, dtype=np.int64)
        big_index[big_txps] = np.arange(n_big_real)
        if not _balance.big_slots(
            txp_id, rank, big_index, big_off_log, CAPK, big_start,
            bp, bq, txp_slot_of_aln,
        ):
            bi = big_index[txp_id[big_idx]]
            rk_big = rank[big_idx]
            row = _bphys(big_off_log[bi] + rk_big // CAPK)
            txp_slot_of_aln[big_idx] = _colmajor_slot(
                big_start, CAPK, row, rk_big % CAPK
            )
    _tick("big_slots")

    BCHn = ((max(n_slots_r, n_slots_t) + BCH - 1) // BCH) * BCH
    n_chk = BCHn // BCH

    # ---- small-transcript placement (pass 1: per-chunk load balance)
    items_t = (
        np.concatenate(small_row_parts)
        if small_row_parts
        else np.empty(0, np.int64)
    )
    sizes_t = counts[items_t]
    ib_t = (
        np.concatenate(
            [
                np.full(len(rows), bi, dtype=np.int64)
                for bi, rows in enumerate(small_row_parts)
            ]
        )
        if small_row_parts
        else np.empty(0, np.int64)
    )
    buckets_t = [
        (start, K, rows_pad // LANES)
        for (rows_pad, K), start in zip(small_shapes, small_starts)
    ]
    off_t = np.zeros(len(items_t) + 1, dtype=np.int64)
    np.cumsum(sizes_t, out=off_t[1:])
    def _gdiv(arr, idx, div):
        """out = (arr[idx] // div).astype(i32) fused natively (the
        repair loop recomputes these A-sized keys repeatedly)."""
        out = _balance.gather_div_i32(arr, idx, div)
        if out is None:
            g = arr[idx] if idx is not None else arr
            out = (g // div).astype(np.int32)
        return out

    def _desc_order(sz, rng):
        """Descending-size placement order with randomized ties: shuffle,
        then stable-sort by size. The native counting sort replaces the
        R-sized argsort (sizes are small ints); stability makes the two
        forms bit-identical."""
        p = rng.permutation(len(sz))
        s = sz[p]
        mx = int(s.max()) if len(s) else 0
        rk = _balance.rank_by_key(mx - s, mx + 1)
        if rk is not None:
            return p[rk[0]]
        return p[np.argsort(-s, kind="stable")]

    rng_b = np.random.default_rng(7)
    if use_balance and len(items_t):
        order_t = _desc_order(sizes_t, rng_b)
        F1 = np.zeros((1, n_chk), dtype=np.int32)
        if n_big_real:
            F1[0] = np.bincount(
                txp_slot_of_aln[big_idx] // BCH, minlength=n_chk
            )[:n_chk]
        row_within_t, _, _ = _balance.greedy_place(
            off_t, np.zeros(int(off_t[-1]), np.int32), ib_t, buckets_t,
            n_chk, 1, order_t, F1,
        )
    else:
        order_t = None
        row_within_t = (
            np.concatenate(
                [np.arange(len(rows)) for rows in small_row_parts]
            )
            if small_row_parts
            else np.empty(0, np.int64)
        )

    sb_flat_base = np.concatenate(
        [[0], np.cumsum([rp for rp, _ in small_shapes])]
    ).astype(np.int64)

    # per-transcript bucket tables and the small-alignment subset are
    # fixed across repair rounds — hoisted out of _apply_small
    _bK_t = np.zeros(T, dtype=np.int64)
    _bst_t = np.zeros(T, dtype=np.int64)
    for (rows_pad, K), start, rows in zip(
        small_shapes, small_starts, small_row_parts
    ):
        _bK_t[rows] = K
        _bst_t[rows] = start
    small_idx = np.nonzero(small_aln)[0]
    tid_small = txp_id[small_idx]
    rank_small = rank[small_idx]

    def _apply_small(row_within):
        """Small-transcript slot tables from per-item bucket rows; also
        (re)writes the small part of txp_slot_of_aln."""
        row_of = np.full(T, -1, dtype=np.int64)
        pos = np.full(T, -1, dtype=np.int64)
        if len(items_t):
            row_of[items_t] = row_within
            pos[items_t] = sb_flat_base[ib_t] + row_within
        if len(small_idx) and not _balance.small_slots(
            tid_small, rank_small, small_idx, _bst_t, _bK_t,
            row_of, txp_slot_of_aln,
        ):
            t = tid_small
            txp_slot_of_aln[small_idx] = _colmajor_slot(
                _bst_t[t], _bK_t[t], row_of[t], rank_small
            )
        return row_of, pos

    row_of_small_txp, small_txp_row_pos = _apply_small(row_within_t)
    _tick("small_pass1")

    # ---- read placement (pass 2: greedy on (txp-chunk, read-chunk)
    # cells — the flow matrix both routes share)
    items_r = (
        np.concatenate(read_row_parts)
        if read_row_parts
        else np.empty(0, np.int64)
    )
    sizes_r = sizes[items_r]
    ib_r = (
        np.concatenate(
            [
                np.full(len(rows), bi, dtype=np.int64)
                for bi, rows in enumerate(read_row_parts)
            ]
        )
        if read_row_parts
        else np.empty(0, np.int64)
    )
    buckets_r = [
        (start, K, rows_pad // LANES)
        for (rows_pad, K), start in zip(read_shapes, read_starts)
    ]
    off_r = np.zeros(len(items_r) + 1, dtype=np.int64)
    np.cumsum(sizes_r, out=off_r[1:])
    tot_r = int(off_r[-1])
    _tick("rp2.setup")
    aln_idx_r = _balance.ramp_fill(off_r, boundaries[items_r], tot_r)
    if aln_idx_r is None:
        col_r = np.arange(tot_r) - np.repeat(off_r[:-1], sizes_r)
        aln_idx_r = np.repeat(boundaries[items_r], sizes_r) + col_r
    else:
        # only the NumPy _apply_reads fallback needs col_r, and native
        # ramp_fill implies the native read_slots path is available
        col_r = None
    _tick("rp2.ramp")
    if use_balance and len(items_r):
        order_r = _desc_order(sizes_r, rng_b)
        _tick("rp2.order")
        row_within_r, _, _ = _balance.greedy_place(
            off_r,
            _gdiv(txp_slot_of_aln, aln_idx_r, BCH),
            ib_r, buckets_r, n_chk, n_chk, order_r,
        )
        _tick("rp2.greedy")
    else:
        row_within_r = (
            np.concatenate(
                [np.arange(len(rows)) for rows in read_row_parts]
            )
            if read_row_parts
            else np.empty(0, np.int64)
        )

    rb_flat_base = np.concatenate(
        [[0], np.cumsum([rp for rp, _ in read_shapes])]
    ).astype(np.int64)
    # read id per PADDED row position (unassigned rows get read 0:
    # their slots are all-zero so any multiplicity routed there is inert)
    read_order = np.zeros(row_space_r, dtype=np.int64)
    slot_of_aln = np.zeros(A, dtype=np.int64)

    Kv_r = np.asarray([K for _, K in read_shapes], dtype=np.int64)
    stv_r = np.asarray(read_starts, dtype=np.int64)
    aln_base_r = boundaries[items_r] if len(items_r) else items_r

    def _apply_reads(row_within):
        if len(items_r):
            read_order[:] = 0
            read_order[rb_flat_base[ib_r] + row_within] = items_r
            if not _balance.read_slots(
                off_r, aln_base_r, ib_r, stv_r, Kv_r, row_within,
                slot_of_aln,
            ):
                slot_of_aln[aln_idx_r] = _colmajor_slot(
                    np.repeat(stv_r[ib_r], sizes_r),
                    np.repeat(Kv_r[ib_r], sizes_r),
                    np.repeat(row_within, sizes_r),
                    col_r,
                )

    _apply_reads(row_within_r)
    _tick("read_pass2")

    # ---- pass 3: re-place small transcripts against the chosen read
    # layout (transposed flow matrix, big flows preloaded)
    if use_balance and len(items_t):
        idx_t = _balance.ramp_fill(
            off_t, run_start[items_t], int(off_t[-1])
        )
        if idx_t is None:
            col_t = np.arange(int(off_t[-1])) - np.repeat(
                off_t[:-1], sizes_t
            )
            idx_t = np.repeat(run_start[items_t], sizes_t) + col_t
        src3 = _gdiv(slot_of_aln, ord2[idx_t], BCH)
        F3 = None
        if n_big_real:
            F3 = _balance.flows2d(
                slot_of_aln, txp_slot_of_aln, BCH, n_chk, n_chk,
                idx=big_idx,
            )
        if F3 is None:
            F3 = np.zeros((n_chk, n_chk), dtype=np.int32)
            if n_big_real:
                np.add.at(
                    F3,
                    (slot_of_aln[big_idx] // BCH,
                     txp_slot_of_aln[big_idx] // BCH),
                    1,
                )
        row_within_t, _, _ = _balance.greedy_place(
            off_t, src3, ib_t, buckets_t, n_chk, n_chk, order_t, F3,
        )
        row_of_small_txp, small_txp_row_pos = _apply_small(row_within_t)
    _tick("small_pass3")

    NPAD = ((max(n_slots_r, n_slots_t) + CH - 1) // CH) * CH

    # ---- pass 4: targeted repair at the SELECTED route granularity.
    # The greedy passes balance at the finest grain; the quota, though,
    # is rounded up to the next legal step (128 with the strided
    # exchange), so only crossing a boundary pays. Re-place items
    # touching over-target cells (exhaustive class scan) at the chosen
    # CR, walking the target down 128 at a time while it sticks.
    import os as _os

    rect_maxflow = None
    route_sel = None
    if (
        use_balance
        and len(items_r)
        and _os.environ.get("OARFISH_NO_REPAIR") != "1"
    ):
        from .static_permute import route_maxflow

        if rect_hint is not None:
            # rectangular target from _try_rect_rebuild: nT txp chunks
            # (src), nR read chunks (dst, diluted), fixed quota target
            CRsel, nT, nR, Q_target = rect_hint
            CHR_sel = CRsel * LANES
        else:
            def _mfs():
                out = {}
                for CR in _CR_CANDIDATES:
                    CHR_c = CR * LANES
                    npad_c = ((NPAD + CHR_c - 1) // CHR_c) * CHR_c
                    out[CR] = route_maxflow(
                        slot_of_aln, txp_slot_of_aln, npad_c,
                        chunk=CHR_c,
                    )
                return out

            CRsel, npad_sel, _geo_sel = route_config(_mfs(), NPAD)
            CHR_sel = CRsel * LANES
            nT = nR = npad_sel // CHR_sel
            Q_target = None
        idx_t2 = _balance.ramp_fill(
            off_t, run_start[items_t], int(off_t[-1])
        )
        if idx_t2 is None:
            idx_t2 = np.repeat(run_start[items_t], sizes_t) + (
                np.arange(int(off_t[-1]))
                - np.repeat(off_t[:-1], sizes_t)
            )
        aln_t = ord2[idx_t2]  # alignment ids in txp-item CSR order
        import logging

        _rlog = logging.getLogger("oarfish_tpu")

        def _flows():
            """[read chunk, txp chunk] loads of the full layout."""
            Fx = _balance.flows2d(
                slot_of_aln, txp_slot_of_aln, CHR_sel, nR, nT
            )
            if Fx is None:
                Fx = np.zeros((nR, nT), dtype=np.int32)
                np.add.at(
                    Fx,
                    (slot_of_aln // CHR_sel,
                     txp_slot_of_aln // CHR_sel),
                    1,
                )
            return Fx

        def _big_F():
            """[read chunk, txp chunk] loads of the FIXED big-txp rows."""
            if n_big_real:
                Fb = _balance.flows2d(
                    slot_of_aln, txp_slot_of_aln, CHR_sel, nR, nT,
                    idx=big_idx,
                )
                if Fb is not None:
                    return Fb
            Fb = np.zeros((nR, nT), dtype=np.int32)
            if n_big_real:
                np.add.at(
                    Fb,
                    (slot_of_aln[big_aln] // CHR_sel,
                     txp_slot_of_aln[big_aln] // CHR_sel),
                    1,
                )
            return Fb

        mf = int(_flows().max())
        _rlog.debug("repair: CR=%d nT=%d nR=%d maxflow=%d mean=%.0f",
                    CRsel, nT, nR, mf, A / (nT * nR))

        # only a crossed 128 boundary changes the rounded quota; local
        # search moves the max by a few units per round, so bail when
        # the gap is beyond striking distance (saves ~2/3 of the layout
        # build at the 6M-alignment bench shape, where mf=188 vs 128)
        gap = mf - ((mf - 1) // LANES) * LANES
        skip_repair = rect_hint is None and gap > 40
        if skip_repair:
            _rlog.debug("repair: gap %d to the next boundary, skipping",
                        gap)
        # re-run the greedy at the SELECTED granularity (the 16K-grain
        # passes above optimize finer cells; the quota is the max over
        # the CHOSEN CR's cells), then local-search repair toward each
        # successive 128 boundary
        if not skip_repair:
            rw_t, rw_r = row_within_t, row_within_r
            row_r2, _, _ = _balance.greedy_place(
                off_r,
                _gdiv(txp_slot_of_aln, aln_idx_r, CHR_sel),
                ib_r, buckets_r, nR, nT, order_r,
                np.ascontiguousarray(_big_F().T), chunk=CHR_sel,
            )
            row_within_r = row_r2
            _apply_reads(row_within_r)
            if len(items_t):
                F3s = _big_F()
                src_t = _gdiv(slot_of_aln, aln_t, CHR_sel)
                row_t2, mx_t, _ = _balance.greedy_place(
                    off_t, src_t, ib_t, buckets_t, nT, nR, order_t,
                    F3s, chunk=CHR_sel,
                )
                row_within_t = row_t2
                row_of_small_txp, small_txp_row_pos = _apply_small(
                    row_within_t
                )
            mf2 = int(_flows().max())
            _rlog.debug("repair: re-greedy at CR -> maxflow=%d", mf2)
            if mf2 > mf:
                # coarse-grain re-placement lost: restore the 16K placement
                row_within_t, row_within_r = rw_t, rw_r
                row_of_small_txp, small_txp_row_pos = _apply_small(
                    row_within_t
                )
                _apply_reads(row_within_r)
                mf2 = mf
            mf = mf2
            if Q_target is not None:
                target = Q_target
            else:
                target = ((mf - 1) // LANES) * LANES
            while target >= LANES:
                Ff = _flows()
                row_t2, mx_t, Ff = _balance.repair_place(
                    off_t, _gdiv(slot_of_aln, aln_t, CHR_sel),
                    ib_t, buckets_t, nT, nR, row_within_t, Ff,
                    target, CHR_sel, max_rounds=8,
                )
                row_within_t = row_t2
                row_of_small_txp, small_txp_row_pos = _apply_small(
                    row_within_t
                )
                if mx_t > target:
                    F2 = np.ascontiguousarray(Ff.T)
                    row_r2, mx_r, _ = _balance.repair_place(
                        off_r,
                        _gdiv(txp_slot_of_aln, aln_idx_r, CHR_sel),
                        ib_r, buckets_r, nR, nT, row_within_r, F2,
                        target, CHR_sel, max_rounds=8,
                    )
                    row_within_r = row_r2
                    _apply_reads(row_within_r)
                    mf = mx_r
                else:
                    mf = mx_t
                _rlog.debug("repair: target=%d -> txp=%d read-side=%d",
                            target, mx_t, mf)
                if mf > target:
                    break
                target -= LANES
            rect_maxflow = mf
        if rect_hint is None:
            # the repair optimized the placement FOR this chunk size;
            # pin (CR, final maxflow) so _v4_finish skips its 3-way
            # route_maxflow recompute over all CR candidates
            route_sel = (CRsel, int(mf))
    _tick("repair_pass4")

    # ---- tiny T-space tile permutes
    t_rows = _tile_rows(max(T, row_space_s + n_big, 1))
    if envelope:
        t_rows = max(t_rows, envelope["t_rows"])
    t_space = t_rows * LANES
    # t_in: out[row pos] = prev[small txp of that row], then the big
    # txps as a dense block after the small row space
    have_s = small_txp_row_pos >= 0
    perm_in = np.full(t_space, -1, dtype=np.int64)
    perm_in[small_txp_row_pos[have_s]] = np.nonzero(have_s)[0]
    if n_big_real:
        perm_in[row_space_s : row_space_s + n_big_real] = big_txps
    used = np.zeros(t_space, dtype=bool)
    used[perm_in[perm_in >= 0]] = True
    free_out = np.nonzero(perm_in < 0)[0]
    perm_in[free_out] = np.nonzero(~used)[0]
    t_in = BatchTilePermute.build([DeviceTilePlan.build(perm_in, t_rows)])

    # t_out: curr[t] = v[pos_of_t]; v = [small row sums (flat row
    # positions), big txp sums, zeros]; empty transcripts route from
    # the zero tail (padded rows sum to zero as well)
    pos_of_txp = np.full(T, -1, dtype=np.int64)
    pos_of_txp[have_s] = small_txp_row_pos[have_s]
    if n_big_real:
        pos_of_txp[big_txps] = row_space_s + np.arange(n_big_real)
    perm_out = np.full(t_space, -1, dtype=np.int64)
    have = pos_of_txp >= 0
    perm_out[np.nonzero(have)[0]] = pos_of_txp[have]
    free_out = np.nonzero(perm_out < 0)[0]
    used = np.zeros(t_space, dtype=bool)
    used[pos_of_txp[have]] = True
    # route empty/pad outputs from slots past the live v prefix where
    # possible (they hold zeros); any leftover free inputs also work
    # because v's tail is zero-filled
    perm_out[free_out] = np.nonzero(~used)[0]
    t_out = BatchTilePermute.build(
        [DeviceTilePlan.build(perm_out, t_rows)]
    )
    _tick("tile_permutes")
    if _os.environ.get("OARFISH_V4_BUILD_TIMING"):
        import logging as _logging

        _logging.getLogger("oarfish_tpu").info(
            "v4 layout phases: %s",
            " ".join(f"{k}={v:.2f}s" for k, v in _phases),
        )

    return {
        "slot_of_aln": slot_of_aln,
        "txp_slot_of_aln": txp_slot_of_aln,
        "weights": weights,
        "NPAD": NPAD,
        "read_order": read_order,
        "t_in": t_in,
        "t_out": t_out,
        # host copies of the tile-permute specs: the plan cache stores
        # these (~2 MB) instead of device_get-ing t_in/t_out back
        # (plan_cache.payload_from_build)
        "t_perm_in": perm_in,
        "t_perm_out": perm_out,
        "t_rows": t_rows,
        "big_row_of_txp": big_row_of_txp,
        "big_row_offsets": big_row_offsets,
        "read_shapes": tuple(read_shapes),
        "read_starts": tuple(read_starts),
        "n_slots_r": n_slots_r,
        "row_space_r": row_space_r,
        "small_shapes": tuple(small_shapes),
        "small_starts": tuple(small_starts),
        "row_space_s": row_space_s,
        "big_rows_pad": big_rows_pad,
        "n_big": n_big,
        "n_slots_t": n_slots_t,
        "t_space": t_space,
        "num_reads": R,
        "num_txps": T,
        "rect_maxflow": rect_maxflow,
        "route_sel": route_sel,
        "dbg": {
            "perm_in": perm_in,
            "perm_out": perm_out,
            "slot_of_aln": slot_of_aln,
            "txp_slot_of_aln": txp_slot_of_aln,
            "NPAD": NPAD,
            "big_txps": big_txps,
        },
    }


_CR_CANDIDATES = (128, 256, 512)  # route chunk sizes (128-lane rows)


def _try_rect_rebuild(txp_id, weights, boundaries, num_txps, lay):
    """Rectangular-geometry rebuild. The square route geometry ties the
    read and transcript chunk counts together; quota boundaries then
    sit near or below the per-cell mean whenever chunks are packed full
    (a full txp chunk's row carries CHR alignments -> row mean CHR/npd;
    at the A=6M bench the big-transcript region pins exactly this and
    repair stalls at ~165 vs the 128 boundary). Instead: keep the txp
    side at its natural chunk count and DILUTE only the read side —
    inflate the read buckets' rows_pad so reads spread over nR > nT
    chunks. Both exchange-legality conditions (n*Q % 16384 == 0) are
    per side, so n_src != n_dst is fine; with Q=128 the strided
    transpose-free exchange applies. Smaller quota area AND smaller
    gather networks; read chunk space exists only inside the fused
    middle stage (the one memory cost is the lvl table and bootstrap
    multiplicities).
    Returns the rebuilt lay (with lay['rect']) or None."""
    import logging
    import math

    log2 = logging.getLogger("oarfish_tpu")
    CR, _npad0, (npd, Q) = route_config(lay, lay["NPAD"])
    CHR = CR * LANES
    A = len(txp_id)
    area0 = npd * npd * Q
    n_ch_t = -(-lay["n_slots_t"] // CHR)
    n_ch_r = -(-lay["n_slots_r"] // CHR)
    best = None
    for Qc in (LANES, 2 * LANES):
        step = (LANES * LANES) // math.gcd(LANES * LANES, Qc)
        nT = -(-n_ch_t // step) * step
        # read chunks needed: 1.45x placement headroom over the mean
        # cell AND full-txp-chunk rows (sum CHR) at <= 0.8*Q mean
        need = max(
            int(np.ceil(1.45 * A / (Qc * max(n_ch_t, 1)))),
            int(np.ceil(CHR / (0.8 * Qc))),
            n_ch_r + 1,
        )
        nR = -(-need // step) * step
        R1 = nR * Qc // LANES
        R3 = nT * Qc // LANES
        if R1 % LANES or R3 % LANES or max(R1, R3) // LANES > 16:
            continue
        if nR * CHR > 3 * lay["n_slots_r"]:
            continue  # read-space inflation cap
        area = nT * nR * Qc
        if best is None or area < best[0]:
            best = (area, Qc, nT, nR)
    if best is None:
        return None
    area, Qc, nT, nR = best
    if area > 0.85 * area0:
        return None

    def inflate(shapes, budget, cur_total):
        # 0.97: rows_pad rounding + group-alignment gaps must not push
        # the read slot space past nR*CHR
        f = 0.97 * budget / max(cur_total, 1)
        if f <= 1.0:
            return None
        return tuple(
            (K, int(np.ceil(rp * f / LANES)) * LANES)
            for rp, K in shapes
        )

    read_b = inflate(lay["read_shapes"], nR * CHR, lay["n_slots_r"])
    if read_b is None:
        return None
    env = {
        "read_buckets": read_b,
        "small_buckets": tuple(
            (K, rp) for rp, K in lay["small_shapes"]
        ),
        "big_rows_pad": lay["big_rows_pad"],
        "n_big": lay["n_big"],
        "t_rows": lay["t_space"] // LANES,
    }
    lay2 = _v4_layout(txp_id, weights, boundaries, num_txps, env,
                      rect_hint=(CR, nT, nR, Qc))
    mf2 = lay2.get("rect_maxflow")
    log2.debug("rect: CR=%d nT=%d nR=%d Q=%d achieved=%s area %d->%d",
               CR, nT, nR, Qc, mf2, area0, area)
    if mf2 is None or mf2 > Qc:
        return None
    if lay2["n_slots_t"] > nT * CHR or lay2["n_slots_r"] > nR * CHR:
        return None
    lay2["rect"] = (CR, nT, nR, Qc)
    return lay2


def route_config(lay_or_maxflows, NPAD: int) -> Tuple[int, int, Tuple]:
    """Pick (chunk_rows, npad_rounded, (npd, Q)) minimizing the
    estimated per-route cost: ~3 HBM passes over the quota tensor plus
    the gather-network VPU work (H_in x H_out block gathers per chunk).
    Larger chunks concentrate the per-pair flows toward their mean
    (less quota inflation) but cost more shuffle work.

    `lay_or_maxflows`: either a layout dict (maxflows computed here) or
    a {chunk_rows: maxflow} dict (shard-uniform builds pass the max over
    shards)."""
    from .static_permute import route_maxflow, select_route_geometry

    if isinstance(lay_or_maxflows, dict) and "slot_of_aln" in lay_or_maxflows:
        lay = lay_or_maxflows
        mfs = {}
        for CR in _CR_CANDIDATES:
            CHR = CR * LANES
            npad_r = ((NPAD + CHR - 1) // CHR) * CHR
            mfs[CR] = route_maxflow(
                lay["slot_of_aln"], lay["txp_slot_of_aln"], npad_r,
                chunk=CHR,
            )
    else:
        mfs = lay_or_maxflows
    import os

    force_cr = os.environ.get("OARFISH_FORCE_CR")
    if force_cr:
        try:
            force_cr_val = int(force_cr)
        except ValueError:
            raise ValueError(
                f"OARFISH_FORCE_CR={force_cr!r} is not an integer; "
                f"available chunk sizes: {sorted(mfs)}"
            ) from None
        if force_cr_val not in mfs:
            raise ValueError(
                f"OARFISH_FORCE_CR={force_cr_val} is not an available chunk "
                f"size; choose one of {sorted(mfs)}"
            )
        mfs = {force_cr_val: mfs[force_cr_val]}
    best = None
    for CR, mf in mfs.items():
        CHR = CR * LANES
        npad_r = ((NPAD + CHR - 1) // CHR) * CHR
        npd, Q = select_route_geometry(npad_r // CHR, mf)
        R1 = npd * Q // LANES
        if R1 % LANES or R1 // LANES > 16:
            continue
        area = npd * npd * Q  # quota elements
        vpu = npd * (CR // LANES) * (R1 // LANES) * (LANES * LANES)
        cost = 3 * area + vpu
        if best is None or cost < best[0]:
            best = (cost, CR, npad_r, (npd, Q))
    if best is None:
        raise ValueError("no feasible route geometry at any chunk size")
    CR, npad_r, (npd, Q) = best[1], best[2], best[3]
    # Transpose-free upgrade: round Q to whole lane tiles so the quota
    # exchange needs no separate transpose (strided slab reads
    # instead); adopt while the quota area grows by at most 35%
    # (scripts/strided_ab_bench.py). OARFISH_ROUTE_Q128 forces it on
    # (1) or off (0) for A/B.
    force = os.environ.get("OARFISH_ROUTE_Q128")
    if force != "0" and Q % LANES != 0:
        npd128, Q128 = select_route_geometry(
            npad_r // (CR * LANES), mfs[CR], q128=True
        )
        R1 = npd128 * Q128 // LANES
        ok = R1 % LANES == 0 and R1 // LANES <= 16
        if ok and (force == "1"
                   or npd128 * Q128 <= 1.35 * npd * Q):
            npd, Q = npd128, Q128
    return CR, npad_r, (npd, Q)


def _read_lvl_ids(read_shapes, read_starts, n_chunks: int,
                  CR: int) -> Optional[np.ndarray]:
    """[n_chunks * CR, 128] i8: per route-chunk row, log2(K) of
    the read bucket owning it, broadcast across lanes (-1 for rows
    outside any read bucket — alignment gaps, the transcript-layout
    region, and the rounding tail). Group-aligned bucket starts
    guarantee no K-row group straddles a chunk, so the fused middle
    stage's pairwise-sum butterfly covers every read. Returns None
    (fused middle disabled) when some bucket is wider than a chunk."""
    CHR = CR * LANES
    if any(K > CR for _rp, K in read_shapes):
        return None
    # stored i8 (4x less table traffic than i32); widened on use
    lvl = np.full(n_chunks * CR, -1, dtype=np.int8)
    for (rows_pad, K), start in zip(read_shapes, read_starts):
        s = int(K).bit_length() - 1
        assert (1 << s) == K, "bucket widths must be powers of two"
        for g in range(rows_pad // LANES):
            base = start + g * K * LANES
            r0 = base // LANES
            assert (base % CHR) // LANES + K <= CR, (
                "read group straddles a route chunk"
            )
            lvl[r0 : r0 + K] = s
    return np.broadcast_to(
        lvl[:, None], (n_chunks * CR, LANES)
    ).copy()


def _v4_finish(lay: dict, geometry=None, cache_key=None,
               pointer_key=None, canonical: bool = False) -> EmV4Data:
    """Phase 2: construct the two GlobalRoutes (optionally with a forced
    shard-uniform (chunk_rows, npad, (npd, Q)) config) and assemble the
    device state. The routes over the unified rounded space are partial
    injective maps: uncovered outputs — the bucket pads — come out
    ZERO, which is exactly the invariant both row-sum stages need.
    With `cache_key` the host-side products are persisted to the plan
    cache on a background thread (ops/plan_cache.py)."""
    from .static_permute import build_route_pair_async

    keep_host = cache_key is not None
    if geometry is None and "rect" in lay:
        # rectangular geometry from _try_rect_rebuild: txp side at its
        # natural chunk count, read side diluted to n_dst chunks
        CR, n_src, n_dst, Q = lay["rect"]
        CHR = CR * LANES
        routes = build_route_pair_async(
            lay["slot_of_aln"], lay["txp_slot_of_aln"], n_src * CHR,
            n_pad_out=n_dst * CHR,
            force_geometry=(n_src, n_dst, Q), chunk_rows=CR,
            keep_host=keep_host,
        )
    else:
        if geometry is None:
            sel = lay.get("route_sel")
            if sel is not None:
                CR, NPAD, geo = route_config({sel[0]: sel[1]},
                                             lay["NPAD"])
            else:
                CR, NPAD, geo = route_config(lay, lay["NPAD"])
            if canonical and "canon" in lay:
                # canonical geometry, sticky like the envelope: reuse
                # the class record's (CR, npd, Q) when it covers this
                # dataset's natural needs; else quantize the chunk
                # count up, respect the npd*Q legality step and the
                # R1 <= 16*128 stage cap, and store the grown record.
                import math as _math

                from . import plan_cache as _pc

                canon_key, canon_env, canon_rec = lay["canon"]
                npd, Q = geo
                stored_geo = (
                    canon_rec.get("geometry") if canon_rec else None
                )
                if (
                    stored_geo is not None
                    and stored_geo[0] == CR
                    and stored_geo[1] >= npd
                    and stored_geo[2] >= Q
                    and stored_geo[1] * stored_geo[2]
                        <= 16 * LANES * LANES
                ):
                    geo = (stored_geo[1], stored_geo[2])
                else:
                    step = (LANES * LANES) // _math.gcd(
                        LANES * LANES, Q
                    )
                    npd_c = -(-_quant_up(npd) // step) * step
                    if npd_c * Q <= 16 * LANES * LANES:
                        geo = (npd_c, Q)
                    if canon_key is not None:
                        _pc.store_env_class(
                            canon_key, canon_env, (CR, geo[0], geo[1])
                        )
        else:
            CR, NPAD, geo = geometry
        routes = build_route_pair_async(
            lay["slot_of_aln"], lay["txp_slot_of_aln"], NPAD,
            force_geometry=geo, chunk_rows=CR,
            keep_host=keep_host,
        )
    import os as _fos
    import time as _time

    _ft0 = _time.perf_counter()
    _ftick_log = _fos.environ.get("OARFISH_V4_BUILD_TIMING")
    _fphases = []

    def _ftick(name):
        nonlocal _ft0
        if _ftick_log:
            t = _time.perf_counter()
            _fphases.append((name, t - _ft0))
            _ft0 = t

    # geometry is known immediately; build + ship everything that only
    # depends on it WHILE the native coloring/table fill runs on its
    # worker thread (it releases the GIL)
    seg_id = _read_lvl_ids(
        lay["read_shapes"], lay["read_starts"], routes.n_dst, CR
    )
    seg_id_dev = None if seg_id is None else jnp.asarray(seg_id)
    _ftick("seg_id")
    # weights stored at the route's padded length so the fused-mul
    # expand stage takes them without a pad copy per iteration
    w_txp = np.zeros(routes.n_src * CR * LANES, dtype=np.float64)
    w_txp[lay["txp_slot_of_aln"]] = lay["weights"]
    lay["dbg"]["w_txp"] = w_txp[: lay["n_slots_t"]]
    w_txp_dev = jnp.asarray(w_txp, dtype=jnp.float32)
    _ftick("w_txp")
    p_a, p_b = routes()
    _ftick("routes.join")
    if cache_key is not None and hasattr(routes, "host"):
        from . import plan_cache

        plan_cache.store_async(
            cache_key,
            plan_cache.payload_from_build(lay, routes.host, seg_id),
            pointer_key=pointer_key,
        )

    if _ftick_log:
        import logging as _logging

        _ftick("store_async")
        _logging.getLogger("oarfish_tpu").info(
            "v4 finish phases: %s",
            " ".join(f"{k}={v:.2f}s" for k, v in _fphases),
        )
    return EmV4Data(
        w_txp=w_txp_dev,
        p_a=p_a,
        p_b=p_b,
        t_in=lay["t_in"],
        t_out=lay["t_out"],
        big_row_of_txp=jnp.asarray(lay["big_row_of_txp"], dtype=jnp.int32),
        big_row_offsets=jnp.asarray(
            lay["big_row_offsets"], dtype=jnp.int32
        ),
        seg_id=seg_id_dev,
        read_shapes=lay["read_shapes"],
        read_starts=lay["read_starts"],
        n_slots_r=lay["n_slots_r"],
        row_space_r=lay["row_space_r"],
        small_shapes=lay["small_shapes"],
        small_starts=lay["small_starts"],
        row_space_s=lay["row_space_s"],
        big_rows_pad=lay["big_rows_pad"],
        n_big=lay["n_big"],
        n_slots_t=lay["n_slots_t"],
        t_space=lay["t_space"],
        num_reads=lay["num_reads"],
        num_txps=lay["num_txps"],
    )


def _row_sums(slots, shapes, starts, xp=jnp):
    """Per-row sums in the column-major layout: flat [sum rows_pad],
    position = bucket row index (pads sum to zero)."""
    parts = []
    for (rows_pad, K), start in zip(shapes, starts):
        g = rows_pad // LANES
        blk = slots[start : start + rows_pad * K].reshape(g, K, LANES)
        parts.append(blk.sum(axis=1).reshape(-1))
    if not parts:
        return xp.zeros(0, slots.dtype)
    return xp.concatenate(parts)


def _row_broadcast(values, shapes, xp=jnp, total=None, starts=None):
    """Inverse of `_row_sums`: expand one value per row across its K
    column-major slots. With `total`, a zero tail pads the result to that
    length (free inside the concatenate — avoids a later pad copy).
    `starts` (required when bucket starts are group-aligned and leave
    gaps) inserts zero blocks so output positions match slot space."""
    parts = []
    roff = 0
    n = 0
    for bi, (rows_pad, K) in enumerate(shapes):
        if starts is not None and starts[bi] > n:
            parts.append(xp.zeros(starts[bi] - n, values.dtype))
            n = starts[bi]
        g = rows_pad // LANES
        blk = values[roff : roff + rows_pad].reshape(g, 1, LANES)
        parts.append(
            xp.broadcast_to(blk, (g, K, LANES)).reshape(-1)
        )
        roff += rows_pad
        n += rows_pad * K
    if total is not None and total > n:
        parts.append(xp.zeros(total - n, values.dtype))
    if not parts:
        return xp.zeros(0, values.dtype)
    return xp.concatenate(parts)


def _prev_slots(data: EmV4Data, prev):
    """Front glue: prev[T] (or prev already padded to t_space — the
    ext-space loop, see make_runner) -> prev in the transcript slot
    layout, zero-tailed to the route pad (steps 1-2 of the m-step)."""
    T = data.num_txps
    dt = prev.dtype
    npad = data.p_a.n_src * data.p_a.chunk_rows * LANES
    # 1. deliver prev to transcript rows (tiny static tile permute)
    if prev.shape[0] == data.t_space:
        ext = prev  # ext-space loop: T never enters this trace
    else:
        ext = jnp.zeros(data.t_space, dt).at[:T].set(prev)
    pr = data.t_in(ext)
    pr_small = pr[: data.row_space_s]
    pr_big = pr[data.row_space_s : data.row_space_s + data.n_big]

    # 2. prev in the transcript layout (zero-tailed to the route pad);
    # the * w_txp product is fused into the expand stage of p_a
    parts = [_row_broadcast(pr_small, data.small_shapes)]
    if data.big_rows_pad:
        pr_rows = jnp.take(pr_big, data.big_row_of_txp)  # tiny static
        g = data.big_rows_pad // LANES
        parts.append(
            jnp.broadcast_to(
                pr_rows.reshape(g, 1, LANES), (g, CAPK, LANES)
            ).reshape(-1)
        )
    if npad > data.n_slots_t:
        parts.append(jnp.zeros(npad - data.n_slots_t, dt))
    return jnp.concatenate(parts)


def _txp_tail(data: EmV4Data, inc_t, ext_space: bool = False):
    """Back glue: transcript-layout increments -> curr[T] (row sums,
    big-transcript second level, output tile permute). With
    `ext_space` the full t_space vector is returned unsliced."""
    T = data.num_txps
    dt = inc_t.dtype
    small_sums = _row_sums(inc_t, data.small_shapes, data.small_starts)
    if data.big_rows_pad:
        g = data.big_rows_pad // LANES
        big_base = data.n_slots_t - data.big_rows_pad * CAPK
        big_rows = inc_t[
            big_base : data.n_slots_t
        ].reshape(g, CAPK, LANES).sum(axis=1).reshape(-1)
        cs = jnp.concatenate([jnp.zeros(1, dt), jnp.cumsum(big_rows)])
        o = data.big_row_offsets
        big_sums = jnp.take(cs, o[1:]) - jnp.take(cs, o[:-1])
        v = jnp.concatenate([small_sums, big_sums])
    else:
        v = small_sums
    vv = jnp.zeros(data.t_space, dt).at[: v.shape[0]].set(v)
    out = data.t_out(vv)
    # ext-space m-step: output length mirrors the input length so the
    # EM while-loop can run entirely in the T-free padded space (pad
    # positions route only zeros and stay zero every iteration)
    return out if ext_space else out[:T]


def _m_step_v4(data: EmV4Data, prev, multiplicity):
    dt = prev.dtype
    # src (transcript-layout) and dst (read-layout) padded spaces — they
    # differ under rectangular route geometry (read side diluted)
    npad_r = data.p_a.n_dst * data.p_a.chunk_rows * LANES
    prev_slots = _prev_slots(data, prev)

    # 3+4. route to the read layout, per-read denominators + scaling,
    # route back. The fused middle path runs route A's reduce stage,
    # the denominator row sums (a butterfly over static group levels),
    # the guarded reciprocal scaling, and route B's expand stage as one
    # per-read-chunk function (static_permute._middle_apply).
    import os

    fuse = os.environ.get("OARFISH_V4_NO_FUSE") != "1"
    middle = (
        data.seg_id is not None
        and os.environ.get("OARFISH_V4_NO_MIDDLE") != "1"
    )
    if middle:
        pa, pb = data.p_a, data.p_b
        # transpose-free exchanges when the quota is whole lane tiles:
        # stage 1 emits the src-major quota tensor and both consumers
        # read their dst-chunk column slab from it
        strided = (
            pa.Q % LANES == 0
            and os.environ.get("OARFISH_V4_NO_STRIDED") != "1"
        )
        mult_slots = None
        if multiplicity is not None:
            mult_slots = _row_broadcast(
                multiplicity.astype(dt), data.read_shapes, total=npad_r,
                starts=data.read_starts,
            ).reshape(-1, LANES)
        max_lvl = max(
            (int(K).bit_length() - 1 for _rp, K in data.read_shapes),
            default=0,
        )
        if strided:
            y1 = pa.expand_y1(prev_slots, mul=data.w_txp.astype(dt))
            qr = pa.Q // LANES
            zg = y1.reshape(pa.n_src, pa.n_dst, qr, LANES)
        else:
            zg = pa.expand(prev_slots, mul=data.w_txp.astype(dt))
            qr = 0
        y1b = _run_middle_stage(
            zg, data.seg_id, pa.s3_r1, pa.s3_src, pa.s3_row, pa.s3_r2,
            pa.s3_mask, pb.s1_r1, pb.s1_src, pb.s1_row, pb.s1_r2,
            n_chunks=pa.n_dst, R_q=pa.R3, R_c=pa.chunk_rows,
            thresh=float(EM_DENOM_THRESH), max_lvl=max_lvl,
            mult=mult_slots, strided_qr=qr,
        )
        if strided:
            inc_t = pb.reduce_strided(y1b, sliced=False)
        else:
            zgb = jnp.transpose(
                y1b.reshape(pb.n_src, pb.n_dst, pb.Q), (1, 0, 2)
            ).reshape(pb.n_dst * pb.R3, LANES)
            inc_t = pb.reduce(zgb, sliced=False)
    else:
        if fuse:
            contrib_r = data.p_a(prev_slots, mul=data.w_txp.astype(dt),
                                 sliced=False)
        else:
            contrib_r = data.p_a(prev_slots * data.w_txp.astype(dt),
                                 sliced=False)
        denom = _row_sums(contrib_r, data.read_shapes, data.read_starts)
        scale = jnp.where(denom > EM_DENOM_THRESH, 1.0 / denom, 0.0)
        if multiplicity is not None:
            scale = scale * multiplicity.astype(dt)
        scale_slots = _row_broadcast(scale, data.read_shapes,
                                     total=npad_r,
                                     starts=data.read_starts)
        if fuse:
            inc_t = data.p_b(contrib_r, mul=scale_slots, sliced=False)
        else:
            inc_t = data.p_b(contrib_r * scale_slots, sliced=False)
    return _txp_tail(data, inc_t,
                     ext_space=prev.shape[0] == data.t_space)


def _batch_eligible(data: EmV4Data) -> bool:
    """Stage-level replicate batching is OPT-IN (OARFISH_V4_BATCH_KERNELS
    =1) and covers the default path only (fused middle + strided
    exchange). NOTE: the knob is read at TRACE time — once a jit cache
    holds a trace, toggling the env var has no effect in that process
    (the A/B scripts clear jax caches between arms; library users must
    set it before the first call). vmap over the whole m-step is the
    default lowering (scripts/batch_kernel_ab.py compares the two)."""
    import os

    return (
        os.environ.get("OARFISH_V4_BATCH_KERNELS") == "1"
        and data.seg_id is not None
        and data.p_a.Q % LANES == 0
        and os.environ.get("OARFISH_V4_NO_MIDDLE") != "1"
        and os.environ.get("OARFISH_V4_NO_STRIDED") != "1"
    )


def _m_step_v4_batch(data: EmV4Data, prev_b, mult_b, max_inner: int = 4):
    """Batched m-step over replicates: the three route stages carry
    the replicate axis themselves, sharing one copy of the static
    routing tables and lvl; the glue around them vmaps. Replicates run
    in sub-batches of `max_inner` to bound the intermediate size.
    Semantics identical to `vmap(lambda p, m: _m_step_v4(data, p, m))`."""
    dt = prev_b.dtype
    pa, pb = data.p_a, data.p_b
    npad_r = pa.n_dst * pa.chunk_rows * LANES
    qr = pa.Q // LANES
    max_lvl = max(
        (int(K).bit_length() - 1 for _rp, K in data.read_shapes),
        default=0,
    )
    prev_slots_b = jax.vmap(lambda p: _prev_slots(data, p))(prev_b)
    mult_slots_b = None
    if mult_b is not None:
        mult_slots_b = jax.vmap(
            lambda m: _row_broadcast(
                m.astype(dt), data.read_shapes, total=npad_r,
                starts=data.read_starts,
            )
        )(mult_b).reshape(mult_b.shape[0], -1, LANES)

    def run_group(ps_g, ms_g):
        B = ps_g.shape[0]
        y1 = pa.expand_y1_batch(ps_g, mul=data.w_txp.astype(dt))
        y1b = _run_middle_stage(
            y1.reshape(B, pa.n_src, pa.n_dst, qr, LANES),
            data.seg_id, pa.s3_r1, pa.s3_src, pa.s3_row, pa.s3_r2,
            pa.s3_mask, pb.s1_r1, pb.s1_src, pb.s1_row, pb.s1_r2,
            n_chunks=pa.n_dst, R_q=pa.R3, R_c=pa.chunk_rows,
            thresh=float(EM_DENOM_THRESH), max_lvl=max_lvl,
            mult=ms_g, strided_qr=qr, B=B,
        )
        return pb.reduce_strided_batch(y1b, sliced=False)

    B = prev_b.shape[0]
    incs = []
    for i in range(0, B, max_inner):
        j = min(i + max_inner, B)
        incs.append(
            run_group(
                prev_slots_b[i:j],
                None if mult_slots_b is None else mult_slots_b[i:j],
            )
        )
    inc_b = incs[0] if len(incs) == 1 else jnp.concatenate(incs, axis=0)
    ext = prev_b.shape[1] == data.t_space
    return jax.vmap(lambda inc: _txp_tail(data, inc, ext_space=ext))(inc_b)


def _m_step_v4_b(data: EmV4Data, prev_b, mult_b):
    """Replicate-batched m-step: stage-level batching when enabled and
    the layout supports it, plain vmap otherwise."""
    if _batch_eligible(data):
        return _m_step_v4_batch(data, prev_b, mult_b)
    if mult_b is None:
        return jax.vmap(lambda p: _m_step_v4(data, p, None))(prev_b)
    return jax.vmap(lambda p, m: _m_step_v4(data, p, m))(prev_b, mult_b)


def make_runner(data: EmV4Data, accel: str = "none"):
    """Jitted EM runner; `data` is a pytree argument. `accel="squarem"`
    runs the squared-extrapolation loop (`em.squarem_loop`) — same
    fixed point, typically 3-10x fewer m-steps on slow-mixing data.

    The EM while-loop runs in the t_space-padded "ext" space: init is
    padded to t_space OUTSIDE the loop's jit and counts sliced back to
    T afterwards, so the loop's HLO is independent of the dataset's
    exact transcript count — with a canonicalized layout (see
    `canonical_envelope`) the compiled program is byte-identical across
    datasets of the same shape class and the persistent XLA compile
    cache serves FIRST runs of new data (VERDICT r3 item 1b). Pad
    positions hold zeros, route to zeros, and are masked out of the
    convergence test (`_rel_diff` requires prev > 1e-5)."""
    T = data.num_txps
    t_space = data.t_space

    def _ext(init):
        if init.shape[0] == t_space:
            return init
        return jnp.zeros(t_space, init.dtype).at[:T].set(init)

    inner = (
        _run_em_v4_squarem_jit if accel == "squarem" else _run_em_v4_jit
    )

    def run_em_v4(init, max_iter, convergence_thresh,
                  multiplicity=None, min_iters=50):
        counts, niter = inner(
            data, _ext(init), max_iter, convergence_thresh,
            multiplicity, min_iters,
        )
        return counts[:T], niter

    return run_em_v4


@functools.partial(jax.jit, static_argnames=("max_iter", "min_iters"))
def _run_em_v4_squarem_jit(data, init, max_iter, convergence_thresh,
                           multiplicity=None, min_iters=50):
    from .em import squarem_em

    return squarem_em(
        lambda p: _m_step_v4(data, p, multiplicity),
        init, max_iter, convergence_thresh, min_iters,
    )


@functools.partial(jax.jit, static_argnames=("max_iter", "min_iters"))
def run_em_v4_batch_squarem(data, init, max_iter, convergence_thresh,
                            mult, min_iters=50):
    """`run_em_v4_batch` with per-replicate SQUAREM acceleration."""
    from .em import squarem_em

    B = mult.shape[0]
    init_b = jnp.broadcast_to(init, (B,) + init.shape)

    def m_step_b(prev_b):
        return _m_step_v4_b(data, prev_b, mult)

    return squarem_em(
        m_step_b, init_b, max_iter, convergence_thresh, min_iters,
        batched=True,
    )


@functools.partial(jax.jit, static_argnames=("max_iter", "min_iters"))
def _run_em_v4_jit(data, init, max_iter, convergence_thresh,
                   multiplicity=None, min_iters=50):
    """Same loop semantics as `run_em` (`em.rs:144-255`)."""
    convergence_thresh = jnp.asarray(convergence_thresh, dtype=init.dtype)

    def cond(state):
        niter, _prev, converged = state
        return jnp.any((niter < max_iter) & (~converged))

    def body(state):
        niter, prev, converged = state
        curr = _m_step_v4(data, prev, multiplicity)
        rd = _rel_diff(prev, curr)
        newly = (rd < convergence_thresh) & (niter > min_iters)
        curr = jnp.where(converged, prev, curr)
        niter = jnp.where(converged, niter, niter + 1)
        return (niter, curr, converged | newly)

    niter, prev, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), init, jnp.asarray(False))
    )
    prev = jnp.where(prev < MIN_READ_THRESH, 0.0, prev)
    counts = _m_step_v4(data, prev, multiplicity)
    return counts, niter


@functools.partial(jax.jit, static_argnames=("max_iter", "min_iters"))
@functools.partial(jax.jit, static_argnames=("max_iter", "min_iters"))
def run_em_v4_batch(data, init, max_iter, convergence_thresh, mult,
                    min_iters=50):
    """Batched bootstrap-replicate EMs: one EM per multiplicity row,
    vmapped through the routed m-step, with per-replicate convergence
    freezing (serial-loop semantics per replicate, `em.rs:144-255`;
    replicate = multiplicity vector, `bootstrap.rs:7-16`).

    jitted: the driver dispatches many replicate chunks with identical
    shapes; without the jit wrapper each chunk RE-TRACED the routed
    while_loop (~seconds of host work per chunk — most of the
    100-replicate wall after the async drain landed, round 5)."""
    convergence_thresh = jnp.asarray(convergence_thresh, dtype=init.dtype)
    B = mult.shape[0]
    init_b = jnp.broadcast_to(init, (B,) + init.shape)

    def m_step_b(prev_b):
        return _m_step_v4_b(data, prev_b, mult)

    def cond(state):
        niter, _prev, conv = state
        return jnp.any((niter < max_iter) & (~conv))

    def body(state):
        niter, prev, conv = state
        curr = m_step_b(prev)
        rd = jax.vmap(_rel_diff)(prev, curr)
        newly = (rd < convergence_thresh) & (niter > min_iters)
        curr = jnp.where(conv[:, None], prev, curr)
        niter = jnp.where(conv, niter, niter + 1)
        return (niter, curr, conv | newly)

    niter, prev, _ = jax.lax.while_loop(
        cond, body,
        (jnp.zeros(B, jnp.int32), init_b, jnp.zeros(B, bool)),
    )
    prev = jnp.where(prev < MIN_READ_THRESH, 0.0, prev)
    counts = m_step_b(prev)
    return counts, niter
