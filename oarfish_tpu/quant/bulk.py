"""Bulk quantification driver: BAM → CSR → device EM → output files.

Equivalent of `bulk.rs` (`quantify_bulk_alignments_from_bam`,
`bulk.rs:212-259`, and the shared inference/output tail
`perform_inference_and_write_output`, `bulk.rs:83-210`). The host packs;
everything numeric (coverage weighting folded into per-alignment weights,
the EM while-loop, the bootstrap batch) runs on the JAX device. There is
no em/em_par split: the device EM is deterministic and uses the serial
path's convergence guard (`niter > 50`), which is the parity target
(SURVEY §3.5 — the reference's parallel path is nondeterministic and uses
a different guard).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

from ..config import Args, FilterOpts, ReadAssignmentProbOut
from ..host.packer import pack_bam
from ..host.store import AlignmentStore, TranscriptCoverage
from ..io.bam import BamReader, verify_header
from ..models.coverage import logistic_prob, normalize_read_probs
from ..models.kde import get_kde_model
from ..ops import bootstrap as bootstrap_ops
from ..ops.em import EmData, em
from ..utils.digest import LazyDigest, digest_from_header
from .meta import get_json_info
from .short_read import read_short_quant_vec
from .writers import (
    get_aux_counts,
    write_infrep_file,
    write_out_prob,
    write_output,
)

log = logging.getLogger("oarfish_tpu")

# `--em-impl auto` on every backend. End to end on an NVIDIA H100 (700 W)
# at R=2M/T=200k/A~6M in f32 (chip_smoke.py), segsum beat fast and v4
# both for a plain run (warm CLI 4.8 s vs 5.9 s and 5.8 s) and with 8
# bootstraps (6.7 s vs 7.9 s): fast iterates 5.7x faster (0.24 vs 1.38
# ms/iter) but its 1.7 s host layout build and slower vmapped replicates
# outweigh ~160 iterations, and v4 (3.2 ms/iter) needs a 4-8 s host
# route build.
AUTO_EM_IMPL = "segsum"


def resolve_em_dtype(em_dtype: str):
    """`auto` picks f64 on CPU (exact parity with the reference's serial
    f64 EM) and f32 on an accelerator. A backend that fails to start
    raises: the run never moves itself to another device."""
    import jax
    import jax.numpy as jnp

    platform = jax.default_backend()
    if em_dtype == "auto":
        em_dtype = "float64" if platform == "cpu" else "float32"
    if em_dtype == "float64":
        jax.config.update("jax_enable_x64", True)
        return jnp.float64
    return jnp.float32


def build_em_inputs(
    store: AlignmentStore,
    num_txps: int,
    model_coverage: bool,
    dens_prob: Optional[np.ndarray],
    dtype,
) -> EmData:
    """Fold the constant per-alignment factors into one weight vector and
    ship the CSR to device (`em.rs:97-111`: prob * cov_prob * dens_prob)."""
    w = store.as_prob.astype(np.float64)
    if model_coverage:
        w = w * store.cov_prob
    if dens_prob is not None:
        w = w * dens_prob
    return EmData.build(
        store.txp_id,
        w,
        store.read_ids(),
        store.num_reads,
        num_txps,
        dtype=dtype,
    )


def perform_inference_and_write_output(
    store: AlignmentStore,
    coverage: TranscriptCoverage,
    txps_name,
    txps_len,
    opts: FilterOpts,
    args: Args,
    digest: dict,
    aln_time_s: float,
    pre: Optional[dict] = None,
    plan_hint=(None, None),
) -> np.ndarray:
    """Shared inference + output tail (`bulk.rs:83-210`). `pre` carries
    the v4 layout inputs prebuilt during the streaming pack; `plan_hint`
    is (plan-cache Prefetch, BAM pointer key) from the driver."""
    log.info("discard table:\n%s", store.discard.to_table())

    if args.sharded_inputs:
        import jax as _jax

        if _jax.process_count() > 1:
            if args.use_kde:
                log.warning(
                    "--use-kde with sharded ingest builds the KDE from "
                    "this process's reads only"
                )
            if opts.model_coverage:
                # the coverage model is a GLOBAL per-transcript statistic:
                # reduce the bin accumulators across processes before
                # evaluating it (bin layout depends only on txp lengths,
                # identical everywhere)
                from ..parallel.multihost import allgather_hosts

                # gather as raw bytes: process_allgather silently
                # downcasts f64->f32 when jax x64 is off, which both
                # loses precision and (before the dtype guard in
                # models/coverage.py) corrupted the native covmodel's
                # in-place bins write
                def _gather_f64(a):
                    g = allgather_hosts(np.ascontiguousarray(a).view(np.uint8))
                    return g.view(np.float64).sum(axis=0)

                coverage.bins = _gather_f64(coverage.bins)
                coverage.total_weight = _gather_f64(coverage.total_weight)

    dens_prob = None
    if args.use_kde:
        kde = get_kde_model(store, coverage.lenf)
        tlen = coverage.lenf[store.txp_id].astype(np.int64)
        aln_len = (store.end - store.start).astype(np.int64)
        dens_prob = kde.lookup(tlen, aln_len)

    if opts.model_coverage:
        t_cov = time.time()
        if os.environ.get("OARFISH_COVMODEL") == "jax":
            # device segment-op formulation (opt-in; the native host
            # pass is the default)
            from ..models.coverage_jax import (
                logistic_prob_jax, normalize_read_probs_jax)

            cov_flat = logistic_prob_jax(coverage, args.growth_rate)
            normalize_read_probs_jax(store, coverage, cov_flat,
                                     args.bin_width)
        else:
            cov_flat = logistic_prob(coverage, args.growth_rate,
                                     threads=args.threads)
            normalize_read_probs(store, coverage, cov_flat, args.bin_width,
                                 threads=args.threads)
        log.info("phase bulk.covmodel %.3f", time.time() - t_cov)

    log.info("Total number of alignment records : %d", store.num_alignments)
    log.info("number of aligned reads : %d", store.num_reads)
    log.info("number of unique alignments : %d", store.num_unique_alignments)

    init = None
    if args.short_quant is not None:
        init = read_short_quant_vec(args.short_quant, txps_name)

    dtype = resolve_em_dtype(args.em_dtype)
    import jax

    if jax.process_count() > 1:
        return _multiprocess_inference_and_write(
            store, txps_name, txps_len, opts, args, digest, aln_time_s,
            dens_prob, init, dtype,
        )

    impl = args.em_impl
    if impl == "auto":
        impl = AUTO_EM_IMPL
        log.info("em-impl auto -> %s", impl)
    # explicit multi-shard request: read-sharded data-parallel EM. With
    # --em-impl v4 the routed v4 iteration is distributed (one
    # psum per iteration, parallel/sharded_v4.py) and bootstrap
    # replicates run as vmapped batches over the same mesh; otherwise
    # the segment-sum sharded EM (bootstraps stay single-device there).
    if args.num_shards > 1:
        if impl == "v4":
            impl = "sharded-v4"
        elif args.num_bootstraps == 0:
            impl = "sharded"

    T = len(txps_name)
    if impl == "v4":
        import jax.numpy as jnp

        from ..ops.em_v4 import EmV4Data, make_runner

        w = store.as_prob.astype(np.float64)
        if opts.model_coverage:
            w = w * store.cov_prob
        if dens_prob is not None:
            w = w * dens_prob
        try:
            t0 = time.time()
            v4data, _order = EmV4Data.build(
                store.txp_id, w, store.boundaries, T,
                pre=pre, prefetch=plan_hint[0], pointer_key=plan_hint[1],
            )
            log.info("v4 routing built in %.1fs", time.time() - t0)
            runner = make_runner(v4data, accel=args.em_accel)
            init_j = (
                jnp.asarray(init, dtype=jnp.float32)
                if init is not None
                else jnp.full(T, store.num_reads / T, dtype=jnp.float32)
            )
            t0 = time.time()
            counts_j, niter = runner(
                init_j, args.max_em_iter, args.convergence_thresh
            )
            counts = np.asarray(counts_j, dtype=np.float64)
            niter = int(niter)
            log.info(
                "v4 EM converged after %d iterations in %.3fs",
                niter, time.time() - t0,
            )
            _pt = os.environ.get("OARFISH_PHASE_TIMING")
            t0 = time.time()
            unique, total = get_aux_counts(store, T)
            if _pt:
                log.info("phase aux_counts %.3fs", time.time() - t0)
            t0 = time.time()
            info = get_json_info(args, opts, store.discard, digest, aln_time_s)
            write_output(
                args.output, info, txps_name, txps_len, counts, unique, total
            )
            if _pt:
                log.info("phase write_output %.3fs", time.time() - t0)
            if args.num_bootstraps > 0:
                rng = np.random.default_rng(args.seed)
                mult = bootstrap_ops.sample_multiplicities(
                    rng, args.num_bootstraps, store.num_reads
                )[:, _order]
                breps = []
                # vmapped replicate batches; the last chunk is padded by
                # repetition so one compilation serves all
                from ..ops.em_v4 import (
                    run_em_v4_batch,
                    run_em_v4_batch_squarem,
                )

                batch_fn = (
                    run_em_v4_batch_squarem
                    if args.em_accel == "squarem"
                    else run_em_v4_batch
                )
                BB = int(os.environ.get("OARFISH_BOOT_BB", "8"))
                BB = max(1, min(BB, args.num_bootstraps))
                # dispatch ALL replicate chunks before syncing any: jax
                # dispatch is async, so chunk k+1's compute overlaps
                # chunk k's result transfer
                pending = []
                b0 = 0
                while b0 < args.num_bootstraps:
                    idx = np.arange(b0, b0 + BB)
                    idx = np.minimum(idx, args.num_bootstraps - 1)
                    # ship multiplicities as int8 when they fit
                    # (multinomial counts rarely exceed a dozen): a
                    # quarter of the f32 host->device bytes
                    mi = mult[idx]
                    if mi.max() <= 127:
                        mdev = jnp.asarray(
                            mi.astype(np.int8)
                        ).astype(jnp.float32)
                    else:
                        mdev = jnp.asarray(mi, dtype=jnp.float32)
                    cb, _ = batch_fn(
                        v4data, init_j, args.max_em_iter,
                        args.convergence_thresh,
                        mdev,
                    )
                    pending.append(
                        (cb, min(BB, args.num_bootstraps - b0))
                    )
                    b0 += BB
                for cb, take in pending:
                    breps.extend(
                        np.asarray(cb[:take], dtype=np.float64)
                    )
                write_infrep_file(args.output, np.stack(breps))
            if args.write_assignment_probs is not None:
                write_out_prob(
                    args.output, store, counts, txps_name,
                    args.display_thresh, opts.model_coverage,
                    compressed=args.write_assignment_probs
                    == ReadAssignmentProbOut.COMPRESSED,
                )
            return counts
        except ValueError as e:
            log.warning("v4 routing unavailable (%s); using 'fast'", e)
            impl = "fast"
    if impl in ("sharded", "sharded-v4"):
        import jax.numpy as jnp

        from ..parallel.sharded_em import sharded_em

        w = store.as_prob.astype(np.float64)
        if opts.model_coverage:
            w = w * store.cov_prob
        if dens_prob is not None:
            w = w * dens_prob
        init_arr = (
            np.asarray(init, dtype=np.float64)
            if init is not None
            else np.full(T, store.num_reads / T)
        )
        counts = None
        breps = None
        if impl == "sharded-v4":
            from ..parallel.sharded_v4 import (
                build_sharded_v4,
                make_sharded_v4_runner,
                sharded_v4_bootstrap,
            )

            try:
                t0 = time.time()
                sh, mesh = build_sharded_v4(
                    store.txp_id, w, store.boundaries, T,
                    num_shards=args.num_shards,
                )
                run = make_sharded_v4_runner(
                    mesh, args.max_em_iter, accel=args.em_accel
                )
                counts_j, niter = run(
                    sh.data,
                    jnp.asarray(init_arr, dtype=dtype),
                    jnp.asarray(args.convergence_thresh, dtype=dtype),
                    None,
                )
                counts = np.asarray(counts_j, dtype=np.float64)
                log.info(
                    "sharded v4 EM (%d shards) converged after %d "
                    "iterations in %.3fs",
                    sh.num_shards,
                    int(niter),
                    time.time() - t0,
                )
                if args.num_bootstraps > 0:
                    rng = np.random.default_rng(args.seed)
                    mult = bootstrap_ops.sample_multiplicities(
                        rng, args.num_bootstraps, store.num_reads
                    )
                    t0 = time.time()
                    breps = sharded_v4_bootstrap(
                        sh, mesh,
                        np.asarray(init_arr, dtype=np.float64),
                        mult.astype(np.float64),
                        max_iter=args.max_em_iter,
                        convergence_thresh=args.convergence_thresh,
                        dtype=dtype,
                        accel=args.em_accel,
                    )
                    log.info(
                        "%d sharded bootstrap replicates in %.3fs",
                        args.num_bootstraps, time.time() - t0,
                    )
            except ValueError as e:
                log.warning(
                    "sharded v4 routing unavailable (%s); using the "
                    "segment-sum sharded EM", e,
                )
                counts = None
                breps = None
        if counts is None:
            t0 = time.time()
            counts, niter = sharded_em(
                store.txp_id,
                w,
                store.boundaries,
                T,
                init_arr,
                max_iter=args.max_em_iter,
                convergence_thresh=args.convergence_thresh,
                dtype=dtype,
                num_shards=args.num_shards,
                accel=args.em_accel,
            )
            log.info(
                "sharded EM (%d shards) converged after %d iterations "
                "in %.3fs",
                args.num_shards or len(jax.devices()),
                niter,
                time.time() - t0,
            )
        unique, total = get_aux_counts(store, T)
        info = get_json_info(args, opts, store.discard, digest, aln_time_s)
        write_output(
            args.output, info, txps_name, txps_len, counts, unique, total
        )
        if args.num_bootstraps > 0:
            if breps is None:
                # sharded-v4 routing was unavailable (tiny/degenerate
                # problem): replicate EMs are cheap there — run them on
                # the single-device segment-sum path
                data = build_em_inputs(
                    store, T, opts.model_coverage, dens_prob, dtype
                )
                breps = bootstrap_ops.bootstrap(
                    data, args.num_bootstraps,
                    max_iter=args.max_em_iter,
                    convergence_thresh=args.convergence_thresh,
                    init_abundances=init,
                    dtype=dtype,
                    seed=args.seed,
                    accel=args.em_accel,
                )
            write_infrep_file(args.output, np.asarray(breps))
        if args.write_assignment_probs is not None:
            write_out_prob(
                args.output, store, counts, txps_name,
                args.display_thresh, opts.model_coverage,
                compressed=args.write_assignment_probs
                == ReadAssignmentProbOut.COMPRESSED,
            )
        return counts
    if impl == "fast":
        import jax.numpy as jnp

        from ..ops.em_fast import (
            FastEmData,
            run_em_fast,
            run_em_fast_squarem,
        )

        if args.em_accel == "squarem":
            run_em_fast = run_em_fast_squarem

        w = store.as_prob.astype(np.float64)
        if opts.model_coverage:
            w = w * store.cov_prob
        if dens_prob is not None:
            w = w * dens_prob
        fdata, _read_order = FastEmData.build(
            store.txp_id, w, store.boundaries, T, dtype=dtype,
        )
        init_j = (
            jnp.asarray(init, dtype=dtype)
            if init is not None
            else jnp.full(T, store.num_reads / T, dtype=dtype)
        )
        t0 = time.time()
        counts_j, niter = run_em_fast(
            fdata, init_j, args.max_em_iter, args.convergence_thresh
        )
        counts = np.asarray(counts_j, dtype=np.float64)
        niter = int(niter)
    else:
        data = build_em_inputs(
            store, T, opts.model_coverage, dens_prob, dtype
        )
        t0 = time.time()
        counts, niter = em(
            data,
            max_iter=args.max_em_iter,
            convergence_thresh=args.convergence_thresh,
            init_abundances=init,
            dtype=dtype,
            accel=args.em_accel,
        )
    log.info("EM converged after %d iterations in %.3fs", niter, time.time() - t0)

    unique, total = get_aux_counts(store, T)
    info = get_json_info(args, opts, store.discard, digest, aln_time_s)
    write_output(args.output, info, txps_name, txps_len, counts, unique, total)

    if args.num_bootstraps > 0:
        t0 = time.time()
        if impl == "fast":
            import jax.numpy as jnp

            rng = np.random.default_rng(args.seed)
            mult = bootstrap_ops.sample_multiplicities(
                rng, args.num_bootstraps, store.num_reads
            )
            # read multiplicities are exchangeable: sample directly in the
            # fast layout's relabeled read order
            run = jax.vmap(
                lambda m: run_em_fast(
                    fdata,
                    init_j,
                    args.max_em_iter,
                    args.convergence_thresh,
                    multiplicity=m,
                )[0]
            )
            breps = np.asarray(
                run(jnp.asarray(mult, dtype=dtype)), dtype=np.float64
            )
        else:
            breps = bootstrap_ops.bootstrap(
                data,
                args.num_bootstraps,
                max_iter=args.max_em_iter,
                convergence_thresh=args.convergence_thresh,
                init_abundances=init,
                dtype=dtype,
                seed=args.seed,
                accel=args.em_accel,
            )
        log.info(
            "%d bootstrap replicates in %.3fs",
            args.num_bootstraps,
            time.time() - t0,
        )
        write_infrep_file(args.output, breps)

    if args.write_assignment_probs is not None:
        write_out_prob(
            args.output,
            store,
            counts,
            txps_name,
            args.display_thresh,
            opts.model_coverage,
            compressed=args.write_assignment_probs
            == ReadAssignmentProbOut.COMPRESSED,
        )

    return counts


def _multiprocess_inference_and_write(
    store, txps_name, txps_len, opts, args, digest, aln_time_s,
    dens_prob, init, dtype,
) -> np.ndarray:
    """Multi-host inference: every process executes the global-mesh
    data-parallel EM (one psum of partial transcript counts per
    iteration over the interconnect — SURVEY §5's first-class distribution
    axis; the reference has no multi-process capability), then process
    0 alone writes the outputs. With `--alignments x.{proc}.bam`
    (args.sharded_inputs) each process packed only ITS shard of the
    reads — distributed ingest — and the per-transcript aux counts and
    discard counters are reduced across processes before writing;
    otherwise every process packs the same BAM and shards are taken by
    global device position."""
    import jax

    from ..parallel.multihost import global_data_mesh, sharded_em_global

    if args.sharded_inputs:
        return _sharded_input_inference_and_write(
            store, txps_name, txps_len, opts, args, digest, aln_time_s,
            dens_prob, init, dtype,
        )

    T = len(txps_name)
    w = store.as_prob.astype(np.float64)
    if opts.model_coverage:
        w = w * store.cov_prob
    if dens_prob is not None:
        w = w * dens_prob
    init_arr = (
        np.asarray(init, dtype=np.float64)
        if init is not None
        else np.full(T, store.num_reads / T)
    )
    mesh = global_data_mesh()
    t0 = time.time()
    counts, niter = sharded_em_global(
        store.txp_id, w, store.boundaries, T,
        init_arr,
        max_iter=args.max_em_iter,
        convergence_thresh=args.convergence_thresh,
        dtype=dtype,
        mesh=mesh,
        accel=args.em_accel,
    )
    log.info(
        "multi-host EM (%d processes, %d devices) converged after %d "
        "iterations in %.3fs",
        jax.process_count(), jax.device_count(), niter, time.time() - t0,
    )
    if jax.process_index() != 0:
        return counts
    unique, total = get_aux_counts(store, T)
    info = get_json_info(args, opts, store.discard, digest, aln_time_s)
    write_output(args.output, info, txps_name, txps_len, counts, unique, total)
    if args.num_bootstraps > 0:
        # replicates run on process 0's local devices (vmapped batch);
        # cheap next to the main EM and avoids a second global program
        data = build_em_inputs(store, T, opts.model_coverage, dens_prob, dtype)
        breps = bootstrap_ops.bootstrap(
            data, args.num_bootstraps,
            max_iter=args.max_em_iter,
            convergence_thresh=args.convergence_thresh,
            init_abundances=init,
            dtype=dtype,
            seed=args.seed,
            accel=args.em_accel,
        )
        write_infrep_file(args.output, np.asarray(breps))
    if args.write_assignment_probs is not None:
        write_out_prob(
            args.output, store, counts, txps_name,
            args.display_thresh, opts.model_coverage,
            compressed=args.write_assignment_probs
            == ReadAssignmentProbOut.COMPRESSED,
        )
    return counts


def _sharded_input_inference_and_write(
    store, txps_name, txps_len, opts, args, digest, aln_time_s,
    dens_prob, init, dtype,
) -> np.ndarray:
    """Distributed-ingest inference: this process's `store` holds only
    its own shard of the reads (disjoint across processes). The EM runs
    over the global mesh with shard shapes agreed across processes; the
    global read count seeds the uniform init; per-transcript aux counts
    and discard counters are host-allgathered and summed before process
    0 writes. Bootstrap replicates are jointly one global multinomial
    via the splitting property (`split_bootstrap_multiplicities`).
    `--write-assignment-probs` emits one part file per process
    (P.part{i}.prob[.lz4]) since read names live only on their owner."""
    import dataclasses

    import jax

    from ..host.filters import DiscardTable
    from ..parallel.multihost import (
        allgather_hosts,
        sharded_em_global_local,
        split_bootstrap_multiplicities,
    )

    T = len(txps_name)
    w = store.as_prob.astype(np.float64)
    if opts.model_coverage:
        w = w * store.cov_prob
    if dens_prob is not None:
        w = w * dens_prob
    r_global = int(
        allgather_hosts(np.array([store.num_reads], dtype=np.int64)).sum()
    )
    init_arr = (
        np.asarray(init, dtype=np.float64)
        if init is not None
        else np.full(T, r_global / T)
    )
    t0 = time.time()
    counts, niter = sharded_em_global_local(
        store.txp_id, w, store.boundaries, T, init_arr,
        max_iter=args.max_em_iter,
        convergence_thresh=args.convergence_thresh,
        dtype=dtype,
        accel=args.em_accel,
    )
    log.info(
        "multi-host EM (%d processes, %d devices, sharded ingest: "
        "%d/%d local reads) converged after %d iterations in %.3fs",
        jax.process_count(), jax.device_count(), store.num_reads,
        r_global, niter, time.time() - t0,
    )

    # reduce the write-side statistics across processes (tiny)
    unique_l, total_l = get_aux_counts(store, T)
    unique = allgather_hosts(unique_l).sum(axis=0)
    total = allgather_hosts(total_l).sum(axis=0)
    dfields = [f.name for f in dataclasses.fields(DiscardTable)]
    dvals = allgather_hosts(
        np.array([getattr(store.discard, f) for f in dfields],
                 dtype=np.int64)
    ).sum(axis=0)
    discard = DiscardTable(**{f: int(v) for f, v in zip(dfields, dvals)})

    breps = None
    if args.num_bootstraps > 0:
        t0 = time.time()
        mult_local = split_bootstrap_multiplicities(
            args.num_bootstraps, store.num_reads, args.seed
        )
        breps, _ = sharded_em_global_local(
            store.txp_id, w, store.boundaries, T, init_arr,
            max_iter=args.max_em_iter,
            convergence_thresh=args.convergence_thresh,
            dtype=dtype,
            accel=args.em_accel,
            mult_local=mult_local,
        )
        log.info(
            "%d bootstrap replicates (sharded ingest) in %.3fs",
            args.num_bootstraps, time.time() - t0,
        )

    if args.write_assignment_probs is not None:
        # every process owns its reads' names/probs: per-process parts
        part = type(args.output)(
            f"{args.output}.part{jax.process_index()}"
        )
        write_out_prob(
            part, store, counts, txps_name,
            args.display_thresh, opts.model_coverage,
            compressed=args.write_assignment_probs
            == ReadAssignmentProbOut.COMPRESSED,
        )
        log.info("assignment probabilities written per process: %s.prob",
                 part)

    if jax.process_index() != 0:
        return counts
    info = get_json_info(args, opts, discard, digest, aln_time_s)
    write_output(args.output, info, txps_name, txps_len, counts, unique, total)
    if breps is not None:
        write_infrep_file(args.output, np.asarray(breps))
    return counts


def quantify_bulk_alignments_from_bam(args: Args, opts: FilterOpts) -> np.ndarray:
    """Alignment-mode entry (`bulk.rs:212-259`)."""
    from ..host.packer import pack_bam_fast

    # Overlap the routed-EM layout pre-work with the streaming pack
    # (VERDICT r2 next-1): a V4Prebuild worker consumes filtered CSR
    # chunks as they land and accumulates the A-sized layout inputs
    # (counts / ranks / read size classes) that _v4_layout would
    # otherwise recompute serially after the pack.
    prebuilder = None
    prefetch = None
    pointer_key = None
    if (
        args.em_impl == "v4"
        and args.num_shards <= 1
        and os.environ.get("OARFISH_PREBUILD") != "0"
    ):
        from ..ops import plan_cache
        from ..ops.em_v4 import V4Prebuild

        # speculative plan prefetch: if this exact BAM + CSR-affecting
        # filter config ran before, ship the cached route tables to the
        # device WHILE the pack streams (verified against the packed
        # CSR's structural key before use)
        fp = (
            f"{opts.five_prime_clip};{opts.three_prime_clip};"
            f"{opts.score_threshold};{opts.min_aligned_fraction};"
            f"{opts.min_aligned_len};{opts.which_strand};"
            f"{opts.score_prob_denom}"
        )
        prefetch = plan_cache.prefetch_for_bam(args.alignments, fp)
        pointer_key = plan_cache.bam_pointer_key(args.alignments, fp)
        # Hedge: run the layout prebuilder even when a prefetch is in
        # flight, and abort it only once the prefetch payload is
        # known-loadable (unpickled + version-checked). If the cached
        # entry was evicted or is corrupt, the overlapped layout build
        # is still there; on the verified hit the prebuild's pre-work
        # would be discarded, so we stop it to give its cores back to
        # the pack.
        prebuilder = V4Prebuild()

    t0 = time.time()
    pack_timings: dict = {}
    observer = None
    if prebuilder is not None:
        # the pointer may also land mid-pack (a preceding run's async
        # store finishing); re-poll per chunk (an os.stat + tiny file
        # read) so a late-arriving plan still overlaps most of the pack
        _pf_box = [prefetch]
        _hedge_done = [False]

        def observer(packed):
            if _pf_box[0] is None:
                _pf_box[0] = plan_cache.prefetch_for_bam(
                    args.alignments, fp
                )
            pf = _pf_box[0]
            if (
                pf is not None
                and not _hedge_done[0]
                and pf.status() == "ok"
            ):
                _hedge_done[0] = True
                prebuilder.abort(quiet=True)
            if not _hedge_done[0]:
                prebuilder.observe(packed)

    try:
        header, store, coverage, _num_unmapped = pack_bam_fast(
            args.alignments,
            opts,
            bin_width=args.bin_width,
            # all threads go to the decoder: its pipeline mode overlaps
            # the consumer phases itself, and the python-side filter is
            # bursty (A/B in PERF_NOTES round 5: threads=4 beats 3+1)
            threads=max(args.threads, 1),
            sort_check_num=args.sort_check_num,
            keep_names=opts.write_assignment_probs,
            timings=pack_timings,
            chunk_observer=observer,
        )
    except BaseException:
        if prebuilder is not None:
            prebuilder.abort()
        raise
    if prebuilder is not None:
        prefetch = _pf_box[0]
    verify_header(header, args.alignments)
    txps_name = header.ref_names
    txps_len = np.asarray(header.ref_lengths, dtype=np.int64)
    log.info("parsed reference information for %d transcripts.", len(txps_name))
    digest = {"bam_digest": LazyDigest(digest_from_header, txps_name, txps_len)}
    t_pb = time.time()
    pre = prebuilder.finish(len(txps_name)) if prebuilder else None
    if os.environ.get("OARFISH_PHASE_TIMING"):
        log.info("phase prebuild.finish %.3fs", time.time() - t_pb)
    aln_time_s = time.time() - t0
    log.info("Parsing of alignments from input took %.3fs", aln_time_s)

    return perform_inference_and_write_output(
        store,
        coverage,
        txps_name,
        txps_len,
        opts,
        args,
        digest,
        aln_time_s,
        pre=pre,
        plan_hint=(prefetch, pointer_key),
    )
