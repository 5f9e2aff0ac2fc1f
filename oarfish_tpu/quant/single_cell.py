"""Single-cell quantification: per-barcode EM over a CB-collated BAM.

Reference behavior: `single_cell.rs:54-267` + the per-barcode helpers in
`alignment_parser.rs:170-299` — records are peeled per contiguous CB tag,
name-sorted (primary before secondary), filtered, given a per-cell
**binomial** coverage model, and quantified with an independent serial EM;
output is a cells×transcripts MatrixMarket matrix plus barcode/feature
lists.

JAX redesign: instead of a worker-thread pool running thousands of
scalar EMs (`single_cell.rs:91-193`), cells are packed into *size buckets*
(alignments/reads/transcripts padded to powers of two), each cell's
transcript ids relabeled to a dense local space, and each bucket runs as a
single `vmap`ped batched EM on device — one compiled program per bucket
shape, all cells in a bucket iterating in lockstep with per-cell
convergence freezing. With `--num-shards > 1` the batch axis is
additionally sharded over a 1-D "cells" device mesh (cells are
independent, so the partitioned program needs no per-cell collectives).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Args, FilterOpts
from ..host.filters import DiscardTable, filter_group
from ..host.store import AlignmentStore, StoreBuilder, TranscriptCoverage
from ..io.bam import BamReader, BamRecord, verify_header
from ..models.coverage import binomial_continuous_prob, normalize_read_probs
from ..ops.em import EmData, run_em
from ..utils.digest import (
    LazyDigest,
    digest_from_header,
    resolve_lazy_digests,
)
from .meta import humantime
from .writers import write_single_cell_output

log = logging.getLogger("oarfish_tpu")


def iter_barcode_groups(records) -> Iterator[Tuple[bytes, List[BamRecord]]]:
    """Yield (barcode, mapped records) for contiguous CB blocks
    (`parse_alignments_for_barcode`, `alignment_parser.rs:244-299`).
    Barcodes are uppercased for comparison (`single_cell.rs:202-210`)."""
    current: Optional[bytes] = None
    group: List[BamRecord] = []
    for rec in records:
        if rec.is_unmapped:
            continue
        if rec.barcode is None:
            raise ValueError("could not get CB tag value")
        bc = rec.barcode.upper()
        if bc != current:
            if current is not None and group:
                yield current, group
            current = bc
            group = []
        group.append(rec)
    if current is not None and group:
        yield current, group


def build_cell_store(
    records: List[BamRecord],
    txp_len: np.ndarray,
    opts: FilterOpts,
    bin_width: int,
) -> Tuple[AlignmentStore, TranscriptCoverage]:
    """Per-cell store: name-sort with primary-first
    (`sort_and_parse_barcode_records`, `alignment_parser.rs:170-241`),
    group by name, filter, pack."""
    records = sorted(records, key=lambda r: (r.name, r.is_secondary))
    coverage = TranscriptCoverage(
        txp_len, bin_width if opts.model_coverage else 0
    )
    builder = StoreBuilder(coverage)
    group: List[BamRecord] = []
    prev = None
    for rec in records:
        if rec.name != prev:
            if group:
                fg = filter_group(opts, builder.discard, txp_len, group)
                builder.add_filtered_group(fg)
            group = []
            prev = rec.name
        if rec.ref_id >= 0:
            group.append(rec)
    if group:
        fg = filter_group(opts, builder.discard, txp_len, group)
        builder.add_filtered_group(fg)
    return builder.finalize(), coverage


def _ceil_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _ceil_ladder(x: int) -> int:
    """Round up to the {pow2, 1.5*pow2} ladder (1,2,3,4,6,8,12,16,...).

    Batch-count shapes (scan length n_sub, small-bucket cell pad) bake
    into the compiled HLO, so leaving them at exact per-dataset values
    defeats the persistent XLA cache across datasets — and each bucket
    program costs seconds to compile. The ladder bounds padding waste at
    33% while
    collapsing the shape space to ~2 values per octave."""
    if x <= 1:
        return 1
    p = 1 << (x - 1).bit_length()  # pow2 >= x
    if 3 * p >= 4 * x:  # x <= 0.75*p -> 1.5*(p/2) covers it
        return (3 * p) // 4
    return p


def _bucket_cost(key) -> int:
    """Per-cell per-iteration work of a bucket shape: the dense matmul
    formulation moves/multiplies the S [a,t] and R [r,a] incidence
    matrices (the segsum path's element count scales the same way)."""
    a, r, t = key
    return a * t + r * a


def coarsen_buckets(buckets: Dict[tuple, "CellBatch"],
                    max_buckets: int = 12) -> Dict[tuple, "CellBatch"]:
    """Merge pow2 size buckets until at most `max_buckets` distinct
    shapes remain. Every distinct bucket shape costs 1-2 XLA
    compilations (tens of seconds through a cold cache), so a long tail
    of rare shapes costs far more in compile time than the padding it
    saves: measured 24 shapes on a 4k-cell workload. Greedy: repeatedly
    take the bucket with the smallest total padded work and move its
    cells into the existing bucket that dominates it on all three dims
    at the least added per-cell cost; if none dominates, merge with the
    cheapest elementwise-max partner. Pure repacking — cell contents and
    EM semantics are untouched. OARFISH_SC_MAX_BUCKETS overrides."""
    import os

    env = os.environ.get("OARFISH_SC_MAX_BUCKETS")
    if env is not None:
        max_buckets = max(1, int(env))
    while len(buckets) > max_buckets:
        # victim: least total padded work (cheapest to re-pad upward)
        victim = min(
            buckets,
            key=lambda k: _bucket_cost(k) * len(buckets[k].cell_index),
        )
        dom = [
            k for k in buckets
            if k != victim and all(x >= y for x, y in zip(k, victim))
        ]
        if dom:
            target = min(dom, key=_bucket_cost)
        else:
            others = [k for k in buckets if k != victim]
            target = min(
                others,
                key=lambda k: _bucket_cost(
                    tuple(max(x, y) for x, y in zip(k, victim))
                ) * (len(buckets[k].cell_index)
                     + len(buckets[victim].cell_index)),
            )
        merged = tuple(max(x, y) for x, y in zip(target, victim))
        vb, tb = buckets.pop(victim), buckets.pop(target)
        nb = buckets.get(merged)
        if nb is None:
            nb = buckets[merged] = CellBatch(*merged, tb.t_global)
        for b in (tb, vb):
            for i in range(len(b.cell_index)):
                nb.add(b.cell_index[i], b.txp_local[i], b.weights[i],
                       b.read_id[i], b.num_reads[i], b.global_ids[i])
    return buckets


class CellBatch:
    """One size bucket of cells, padded and stacked for a vmapped EM."""

    def __init__(self, a_pad: int, r_pad: int, t_pad: int, t_global: int):
        self.a_pad, self.r_pad, self.t_pad = a_pad, r_pad, t_pad
        self.t_global = t_global
        self.txp_local: List[np.ndarray] = []
        self.weights: List[np.ndarray] = []
        self.read_id: List[np.ndarray] = []
        self.num_reads: List[int] = []
        self.global_ids: List[np.ndarray] = []
        self.cell_index: List[int] = []

    def add(self, cell_index, txp_local, w, read_id, num_reads, global_ids):
        self.txp_local.append(txp_local)
        self.weights.append(w)
        self.read_id.append(read_id)
        self.num_reads.append(num_reads)
        self.global_ids.append(global_ids)
        self.cell_index.append(cell_index)

    def run(self, args: Args, dtype, mesh=None):
        """Batched EM over this bucket; returns per-cell (global_ids,
        counts) in bucket order. (dispatch + immediate drain)."""
        return self.dispatch(args, dtype, mesh=mesh)()

    def dispatch(self, args: Args, dtype, mesh=None):
        """Enqueue this bucket's device EM and return a finalize()
        closure that drains the result. Dispatch is async (jax), so the
        caller can enqueue EVERY bucket before draining any: bucket
        k+1's host build + transfer overlap bucket k's device compute.

        Two device formulations:
        - "segsum" (the default, `auto`): vmapped sparse segment-sum
          EM, the pinned-golden parity path. On an NVIDIA H100 it beat
          dense at 20,000 cells x 50 reads (chip_smoke.py: cell EMs
          0.67 s vs 1.05 s warm, 4.1 s vs 8.9 s cold).
        - "dense": the bucket's incidence structure as one-hot matrices
          and the E/M step as four batched matmuls (`ops/em_dense.py`).
        `OARFISH_SC_IMPL={auto,dense,segsum}` overrides.

        With `mesh` (a 1-D "cells" device mesh), the batch axis is
        sharded across the mesh devices: cell EMs are independent, so
        the partitioned program's only cross-device traffic is the
        batched while-loop's scalar convergence reduce — the north-star
        "single-cell batches laid out on the chip axis" (SURVEY §5;
        the reference runs a worker-thread pool of scalar EMs instead,
        `single_cell.rs:91-193`)."""
        import os

        impl = os.environ.get("OARFISH_SC_IMPL", "auto")
        if impl == "dense":
            return self._dispatch_dense(args, dtype, mesh)
        B = len(self.txp_local)
        Bp = B
        if mesh is not None:
            D = int(mesh.devices.size)
            Bp = ((B + D - 1) // D) * D
        a_p, r_p, t_p = self.a_pad, self.r_pad, self.t_pad
        # padding: dummy alignments with w=0 on a dummy read (r_p) and a
        # dummy transcript slot (t_p); dummy reads get denom 0 -> dropped.
        # Rows [B, Bp) are whole dummy cells (zero init, zero weights):
        # they converge with everyone else and are sliced away below.
        txp = np.full((Bp, a_p), t_p, dtype=np.int32)
        wts = np.zeros((Bp, a_p), dtype=np.float64)
        rid = np.full((Bp, a_p), r_p, dtype=np.int32)
        perm = np.zeros((Bp, a_p), dtype=np.int32)
        tsorted = np.full((Bp, a_p), t_p, dtype=np.int32)
        init = np.zeros((Bp, t_p + 1), dtype=np.float64)
        for i in range(B):
            a = len(self.txp_local[i])
            txp[i, :a] = self.txp_local[i]
            wts[i, :a] = self.weights[i]
            rid[i, :a] = self.read_id[i]
            p = np.argsort(txp[i], kind="stable").astype(np.int32)
            perm[i] = p
            tsorted[i] = txp[i][p]
            # uniform init avg = R_cell / T_global (`em.rs:164-166` with the
            # cell's read count over the FULL transcriptome size)
            init[i, :] = self.num_reads[i] / self.t_global

        def put(x):
            if mesh is None:
                return jnp.asarray(x)
            from jax.sharding import NamedSharding, PartitionSpec

            return jax.device_put(
                x, NamedSharding(mesh, PartitionSpec("cells"))
            )

        data = EmData(
            txp_id=put(txp),
            weights=put(wts.astype(dtype)),
            read_id=put(rid),
            txp_sort_perm=put(perm),
            txp_id_sorted=put(tsorted),
            num_reads=r_p + 1,
            num_txps=t_p + 1,
        )
        init = init.astype(dtype)
        if args.em_accel == "squarem":
            from ..ops.em import run_em_squarem as _run
        else:
            _run = run_em
        counts_dev, _ = jax.vmap(
            lambda d, i0: _run(
                d, i0, args.max_em_iter, args.convergence_thresh
            )
        )(data, put(init))

        def finalize():
            counts = np.asarray(counts_dev[:B], dtype=np.float64)
            out = []
            for i in range(B):
                t_c = len(self.global_ids[i])
                out.append(
                    (self.cell_index[i], self.global_ids[i], counts[i, :t_c])
                )
            return out

        return finalize

    def _dense_sub_batch(self, n_devices: int) -> int:
        """Cells per dense sub-batch under a device-memory budget: the
        one-hot matrices scale as B*(a_pad*t_pad + r_pad*a_pad), so a
        populous bucket run as one batch would OOM (host AND device) at
        production cell counts. ~8 bytes/element covers the bf16 store,
        the compute-dtype widen, and einsum temporaries.
        OARFISH_SC_DENSE_BUDGET_MB overrides (default 1024)."""
        import os

        budget = int(
            os.environ.get("OARFISH_SC_DENSE_BUDGET_MB", "1024")
        ) << 20
        per_cell = 8 * (
            self.a_pad * self.t_pad + self.r_pad * self.a_pad
        )
        sub = max(1, budget // max(per_cell, 1))
        # keep the batch divisible over the cells mesh
        return max(n_devices, (sub // n_devices) * n_devices)

    def _dispatch_dense(self, args: Args, dtype, mesh=None):
        """Dense one-hot matmul formulation (see `run`). Large buckets run
        as fixed-size sub-batches (one compiled shape; the tail is
        padded with inert dummy cells) so peak memory stays bounded by
        the budget rather than the bucket's cell count — but the whole
        bucket ships as ONE stacked transfer and runs as ONE device
        program (`run_em_dense_scan`) instead of one host round trip
        per sub-batch."""
        from ..ops.em_dense import DenseCellEm, run_em_dense_scan

        B = len(self.txp_local)
        D = int(mesh.devices.size) if mesh is not None else 1
        budget_sub = self._dense_sub_batch(D)
        if B <= budget_sub:
            # one sub-batch; quantize its width so the compiled shape
            # recurs across datasets (see _ceil_ladder)
            sub = min(_ceil_ladder((B + D - 1) // D) * D, budget_sub)
            n_sub = 1
        else:
            sub = budget_sub
            n_sub = _ceil_ladder((B + sub - 1) // sub)
        Bp = n_sub * sub

        def put(x):
            if mesh is None:
                return jnp.asarray(x)
            from jax.sharding import NamedSharding, PartitionSpec

            # sub-batch axis scans on every device; cells shard axis 1
            return jax.device_put(
                x, NamedSharding(mesh, PartitionSpec(None, "cells"))
            )

        def put_stacked(x):
            return put(np.asarray(x).reshape((n_sub, sub) + x.shape[1:]))

        empty_i = np.empty(0, dtype=np.int32)
        empty_f = np.empty(0, dtype=np.float64)
        pad = Bp - B
        txp_local = list(self.txp_local) + [empty_i] * pad
        weights = list(self.weights) + [empty_f] * pad
        read_id = list(self.read_id) + [empty_i] * pad
        num_reads = list(self.num_reads) + [0] * pad
        data = DenseCellEm.build(
            txp_local, weights, read_id,
            self.a_pad, self.r_pad, self.t_pad,
            dtype=dtype, put=put_stacked,
        )
        # uniform init = R_cell / T_global broadcast over t_pad: build it
        # ON DEVICE from the tiny per-cell read-count vector instead of
        # shipping a [Bp, t_pad] f32 matrix (~100 MB at 100k cells)
        nr_dev = put_stacked(
            np.asarray(num_reads, dtype=np.float64).astype(dtype)
        )
        t_pad = self.t_pad
        t_global = float(self.t_global)

        @jax.jit
        def _expand_init(nr):
            return jnp.broadcast_to(
                (nr / t_global)[..., None], nr.shape + (t_pad,)
            )

        cc, _ = run_em_dense_scan(
            data, _expand_init(nr_dev),
            args.max_em_iter, args.convergence_thresh,
            accel=args.em_accel == "squarem",
        )

        def finalize():
            counts = np.asarray(cc, dtype=np.float64).reshape(
                Bp, self.t_pad
            )[:B]
            out = []
            for i in range(B):
                t_c = len(self.global_ids[i])
                out.append(
                    (self.cell_index[i], self.global_ids[i], counts[i, :t_c])
                )
            return out

        return finalize


def _iter_cells_native(args: Args, opts: FilterOpts):
    """Fast path: C++ columnar decode + whole-file vectorized filtering,
    then per-cell CSR slices. Yields (header, iterator of
    (barcode, txp_id, start, end, prob, boundaries)). With the coverage
    model on, the caller builds the per-cell binomial model from the
    (post-filter) slices — identical bins to the streaming path."""
    from ..host import native
    from ..host.vector_filter import filter_records

    dec = native.decode_bam(
        args.alignments,
        threads=max(args.threads - 1, 1),
        sort_check_num=args.sort_check_num,
        want_barcodes=True,
    )
    if dec is None:
        return None
    if dec.cb_id is None or (len(dec.cb_id) and (dec.cb_id < 0).any()):
        raise ValueError("could not get CB tag value")
    header = dec.header
    cols = dec.columns
    txps_len = np.asarray(header.ref_lengths, dtype=np.int64)

    # reorder records within each name group: primary before secondary
    # (`sort_and_parse_barcode_records`, `alignment_parser.rs:180-191`)
    secondary = ((cols.flag & 0x100) != 0).astype(np.int8)
    order = np.lexsort((secondary, cols.group_id))
    for f in ("group_id", "flag", "ref_id", "pos", "ref_span", "seq_len",
              "score", "has_score"):
        setattr(cols, f, getattr(cols, f)[order])
    cb_sorted = dec.cb_id[order]

    packed = filter_records(opts, txps_len, cols)

    # cell = contiguous run of one barcode (a re-appearing barcode starts a
    # new row, like the reference's peel loop, `single_cell.rs:200-227`)
    G = cols.num_groups
    cb_of_group = np.full(G, -1, dtype=np.int64)
    cb_of_group[cols.group_id[::-1]] = cb_sorted[::-1]
    # run ids over groups in original order
    group_order = np.arange(G)
    cbs = cb_of_group[group_order]
    present = cbs >= 0
    run_of_group = np.zeros(G, dtype=np.int64)
    if G:
        changes = np.ones(G, dtype=bool)
        changes[1:] = cbs[1:] != cbs[:-1]
        run_of_group = np.cumsum(changes) - 1
    # barcode of each run = the (constant) barcode of its first group,
    # vectorized (a Python loop over G groups costs seconds at 100k
    # cells; measured in scripts/sc_e2e_bench.py)
    n_runs = int(run_of_group[-1]) + 1 if G else 0
    first_g = np.nonzero(changes)[0] if G else np.empty(0, np.int64)
    run_cb = cbs[first_g] if G else np.empty(0, np.int64)

    def cells():
        # reads arrive in group order (records were lexsorted by
        # group_id and the filter preserves order), and run ids are
        # non-decreasing in group order — so rows_run is sorted and
        # every run is a CONTIGUOUS read range whose alignments are a
        # contiguous CSR slice. The previous per-run `rows_run == r`
        # scan was O(R) per cell = O(R*C) total (~2 ms/cell at R=5M:
        # the whole parse phase, not the EM, dominated a 100k-cell
        # run); searchsorted + slicing is O(R + C log R).
        rows_run = run_of_group[packed.group_of_read]
        assert len(rows_run) == 0 or (np.diff(rows_run) >= 0).all(), (
            "reads not in run order; grouping invariant broken"
        )
        starts = np.searchsorted(
            rows_run, np.arange(n_runs + 1, dtype=np.int64)
        )
        for r in range(n_runs):
            lo, hi = int(starts[r]), int(starts[r + 1])
            cb = int(run_cb[r]) if r < len(run_cb) else -1
            bc = dec.barcodes[cb] if cb >= 0 else ""
            if hi == lo:
                yield bc, None
                continue
            alo = int(packed.boundaries[lo])
            ahi = int(packed.boundaries[hi])
            b = packed.boundaries[lo : hi + 1] - alo
            yield bc, (
                packed.txp_id[alo:ahi],
                packed.start[alo:ahi],
                packed.end[alo:ahi],
                packed.prob[alo:ahi],
                b,
            )

    return header, cells()


def quantify_single_cell_from_collated_bam(args: Args, opts: FilterOpts):
    from ..host import native

    if native.available():
        return _quantify_single_cell_native(args, opts)
    return _quantify_single_cell_streaming(args, opts)


def _quantify_single_cell_native(args: Args, opts: FilterOpts):
    from .bulk import resolve_em_dtype

    header, cell_iter = _iter_cells_native(args, opts)
    from ..io.bam import verify_header as _verify

    _verify(header, args.alignments)
    txps_name = header.ref_names
    txps_len = np.asarray(header.ref_lengths, dtype=np.int64)
    T = len(txps_name)
    digest = {"bam_digest": LazyDigest(digest_from_header, txps_name, txps_len)}
    dtype = resolve_em_dtype(args.em_dtype)

    from ..utils.progress import Progress

    t_start = time.time()
    barcodes: List[str] = []
    buckets: Dict[Tuple[int, int, int], CellBatch] = {}
    num_cells = 0
    skipped_empty = 0
    prog = Progress("packing cells", unit="cells")
    for bc, cell in cell_iter:
        prog.update()
        barcodes.append(bc)
        idx_cell = num_cells
        num_cells += 1
        if cell is None:
            skipped_empty += 1
            continue
        txp, start, end, prob, b = cell
        if opts.model_coverage:
            # per-cell binomial coverage model over the RETAINED
            # alignments (the reference builds a fresh per-cell model,
            # `single_cell.rs:132-137`); slices are post-filter so the
            # bins match the streaming path exactly
            cov = TranscriptCoverage(txps_len, args.bin_width)
            cov.add_intervals(txp, start, end)
            cell_store = AlignmentStore(
                txp_id=txp.astype(np.int32), start=start, end=end,
                as_prob=prob.astype(np.float32),
                cov_prob=np.zeros(len(txp)), boundaries=b,
                discard=DiscardTable(),
            )
            flat = binomial_continuous_prob(cov)
            normalize_read_probs(cell_store, cov, flat, args.bin_width)
            w = cell_store.as_prob.astype(np.float64) * cell_store.cov_prob
        else:
            w = prob.astype(np.float64)
        global_ids, local = np.unique(txp, return_inverse=True)
        key = (
            _ceil_pow2(len(txp)),
            _ceil_pow2(len(b) - 1),
            _ceil_pow2(len(global_ids)),
        )
        batch = buckets.get(key)
        if batch is None:
            batch = buckets[key] = CellBatch(*key, T)
        sizes = np.diff(b)
        rid = np.repeat(np.arange(len(b) - 1, dtype=np.int32), sizes)
        batch.add(idx_cell, local.astype(np.int32), w, rid, len(b) - 1,
                  global_ids)
        if num_cells % 100 == 0:
            log.info("Processed %d cells.", num_cells)

    prog.close()
    n_raw = len(buckets)
    buckets = coarsen_buckets(buckets)
    log.info(
        "parsed %d cells (%d with no surviving alignments) in %s; "
        "%d size buckets (%d before coarsening)",
        num_cells, skipped_empty, humantime(time.time() - t_start),
        len(buckets), n_raw,
    )
    log.info("phase sc.parse %.3f", time.time() - t_start)
    return _finish_single_cell(
        args, buckets, barcodes, num_cells, txps_name, digest, dtype
    )


def _quantify_single_cell_streaming(args: Args, opts: FilterOpts):
    reader = BamReader(args.alignments, threads=max(args.threads - 1, 1))
    verify_header(reader.header, args.alignments)
    txps_name = reader.header.ref_names
    txps_len = np.asarray(reader.header.ref_lengths, dtype=np.int64)
    T = len(txps_name)
    digest = {"bam_digest": LazyDigest(digest_from_header, txps_name, txps_len)}

    from .bulk import resolve_em_dtype

    dtype = resolve_em_dtype(args.em_dtype)

    from ..utils.progress import Progress

    t_start = time.time()
    barcodes: List[str] = []
    buckets: Dict[Tuple[int, int, int], CellBatch] = {}
    num_cells = 0
    skipped_empty = 0

    prog = Progress("packing cells", unit="cells")
    for barcode, records in iter_barcode_groups(reader.records()):
        prog.update()
        store, coverage = build_cell_store(records, txps_len, opts, args.bin_width)
        if store.num_reads == 0:
            # the reference still runs the EM (yielding all-zero counts) and
            # writes the barcode row; we record the barcode with no entries
            barcodes.append(barcode.decode("ascii", "replace"))
            num_cells += 1
            skipped_empty += 1
            continue
        if opts.model_coverage:
            flat = binomial_continuous_prob(coverage)
            normalize_read_probs(store, coverage, flat, args.bin_width)
            w = store.as_prob.astype(np.float64) * store.cov_prob
        else:
            w = store.as_prob.astype(np.float64)

        # relabel to a dense local transcript space
        global_ids, local = np.unique(store.txp_id, return_inverse=True)
        key = (
            _ceil_pow2(store.num_alignments),
            _ceil_pow2(store.num_reads),
            _ceil_pow2(len(global_ids)),
        )
        batch = buckets.get(key)
        if batch is None:
            batch = buckets[key] = CellBatch(*key, T)
        batch.add(
            num_cells,
            local.astype(np.int32),
            w,
            store.read_ids(),
            store.num_reads,
            global_ids,
        )
        barcodes.append(barcode.decode("ascii", "replace"))
        num_cells += 1
        if num_cells % 100 == 0:
            log.info("Processed %d cells.", num_cells)

    prog.close()
    n_raw = len(buckets)
    buckets = coarsen_buckets(buckets)
    log.info(
        "parsed %d cells (%d with no surviving alignments) in %s; "
        "%d size buckets (%d before coarsening)",
        num_cells,
        skipped_empty,
        humantime(time.time() - t_start),
        len(buckets), n_raw,
    )
    log.info("phase sc.parse %.3f", time.time() - t_start)
    return _finish_single_cell(
        args, buckets, barcodes, num_cells, txps_name, digest, dtype
    )


def _cell_mesh(args: Args):
    """1-D "cells" mesh for `--num-shards > 1`: cell batches shard on
    their leading axis (embarrassingly parallel across devices)."""
    if args.num_shards <= 1:
        return None
    devs = jax.devices()
    D = min(args.num_shards, len(devs))
    if D <= 1:
        return None
    from jax.sharding import Mesh

    log.info("single-cell EM batches sharded over %d devices", D)
    return Mesh(np.asarray(devs[:D]), ("cells",))


def _finish_single_cell(args, buckets, barcodes, num_cells, txps_name,
                        digest, dtype):
    row_parts: List[np.ndarray] = []
    col_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    t_em = time.time()
    mesh = _cell_mesh(args)
    # enqueue every bucket before draining any (see CellBatch.dispatch)
    pending = [
        (key, buckets[key].dispatch(args, dtype, mesh=mesh))
        for key in sorted(buckets)
    ]
    for key, finalize in pending:
        for cell_index, gids, counts in finalize():
            nz = counts > 0.0
            n = int(np.count_nonzero(nz))
            if n == 0:
                continue
            row_parts.append(np.full(n, cell_index, dtype=np.int64))
            col_parts.append(np.asarray(gids[nz], dtype=np.int64))
            val_parts.append(counts[nz].astype(np.float32))
    empty64 = np.empty(0, np.int64)
    rows = np.concatenate(row_parts) if row_parts else empty64
    cols = np.concatenate(col_parts) if col_parts else empty64
    vals = (np.concatenate(val_parts) if val_parts
            else np.empty(0, np.float32))
    log.info("ran %d cell EMs in %s", num_cells, humantime(time.time() - t_em))
    log.info("phase sc.em %.3f", time.time() - t_em)
    t_wr = time.time()

    info = {
        "prob_model": "logistic_coverage" if args.model_coverage else "no_coverage",
        "bin_width": args.bin_width,
        "alignments": str(args.alignments),
        "output": str(args.output),
        "verbose": args.verbose,
        "single_cell": True,
        "quiet": args.quiet,
        "em_max_iter": args.max_em_iter,
        "em_convergence_thresh": args.convergence_thresh,
        "threads": args.threads,
        "filter_group": None,
        "short_quant": args.short_quant,
        "digest": resolve_lazy_digests(digest),
    }
    write_single_cell_output(
        args.output,
        info,
        txps_name,
        barcodes,
        np.asarray(rows),
        np.asarray(cols),
        np.asarray(vals, dtype=np.float32),
        num_cells,
    )
    log.info("phase sc.write %.3f", time.time() - t_wr)
    return num_cells
