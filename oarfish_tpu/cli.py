"""Command-line interface.

Mirrors the reference's flag surface (`src/prog_opts.rs:250-566`) and mode
dispatch (`src/main.rs:319-485`): same flag names, defaults, filter-group
overlay semantics, and input-mode exclusivity rules.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from .config import (
    Args,
    FilterGroup,
    FilterValue,
    I64_MAX,
    ProjProbSource,
    ReadAssignmentProbOut,
    SequencingTech,
    Strand,
    U32_MAX,
    parse_display_thresh,
    resolve_filters,
)


def _pos_f32(s: str) -> float:
    v = float(s)
    if v <= 0:
        raise argparse.ArgumentTypeError(f"value must be > 0, but got {v}")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="oarfish-tpu",
        description=(
            "accurate transcript quantification from long-read RNA-seq data "
            "(JAX engine)"
        ),
    )
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--verbose", action="store_true")

    # alignment mode
    p.add_argument("-a", "--alignments", type=Path)
    # raw read mode
    p.add_argument("--reads", type=lambda s: [Path(x) for x in s.split(",")])
    p.add_argument("--annotated", type=Path)
    p.add_argument("--novel", type=Path)
    p.add_argument("--index", type=Path)
    p.add_argument("--seq-tech", type=SequencingTech.parse)
    p.add_argument("--best-n", type=int, default=100)
    p.add_argument("--dp-cache-cap-mb", type=int)
    # genome mode
    p.add_argument("--genome-alignments", type=Path)
    p.add_argument("--genome", type=Path)
    p.add_argument("--annotation", type=Path)
    p.add_argument("--genome-fasta", type=Path)
    p.add_argument("--no-rescue", action="store_true")
    p.add_argument("--junctions", type=Path)
    p.add_argument("--ignore-annotation-junctions", action="store_true")
    p.add_argument("--projected-prob-beta", type=float, default=10.0)
    p.add_argument(
        "--projected-prob-source",
        type=lambda s: ProjProbSource(s.lower()),
        default=ProjProbSource.SIMILARITY,
    )
    p.add_argument("--junc-miss-discount", type=float, default=1.0)
    # indexing
    p.add_argument("--only-index", action="store_true")
    p.add_argument("--index-out", type=Path)

    p.add_argument("-o", "--output", type=Path)

    # filters (None = not provided; preset defaults applied in resolve)
    p.add_argument(
        "--filter-group",
        type=lambda s: FilterGroup(s.lower()),
        choices=list(FilterGroup),
        metavar="{no-filters,nanocount-filters}",
    )
    p.add_argument("-t", "--three-prime-clip", type=int, default=None)
    p.add_argument("-f", "--five-prime-clip", type=int, default=None)
    p.add_argument("-s", "--score-threshold", type=float, default=None)
    p.add_argument("-m", "--min-aligned-fraction", type=float, default=None)
    p.add_argument("-l", "--min-aligned-len", type=int, default=None)
    p.add_argument("-d", "--strand-filter", type=Strand.parse, default=Strand.BOTH)
    p.add_argument("--score-prob-denom", type=_pos_f32, default=None)

    p.add_argument("--single-cell", action="store_true")

    # coverage model
    p.add_argument("--model-coverage", action="store_true")
    p.add_argument("-k", "--growth-rate", type=float, default=2.0)
    p.add_argument("-b", "--bin-width", type=int, default=100)

    # probability output
    p.add_argument(
        "--write-assignment-probs",
        nargs="?",
        const="uncompressed",
        default=None,
        type=str,
    )
    p.add_argument(
        "--display-thresh", type=parse_display_thresh, default=1e-6
    )

    # EM
    p.add_argument("--max-em-iter", type=int, default=1000)
    p.add_argument("--convergence-thresh", type=float, default=1e-3)
    p.add_argument("-q", "--short-quant", type=str)
    p.add_argument("--num-bootstraps", type=int, default=0)

    p.add_argument("-j", "--threads", type=int, default=3)
    p.add_argument("--sort-check-num", type=int, default=100_000)
    p.add_argument("-u", "--use-kde", action="store_true")

    # extensions beyond the reference
    p.add_argument(
        "--em-dtype",
        choices=["auto", "float32", "float64"],
        default="auto",
        help="EM compute precision (auto: f64 on CPU, f32 on an "
        "accelerator)",
    )
    p.add_argument(
        "--em-impl",
        choices=["auto", "segsum", "fast", "v4"],
        default="auto",
        help="EM iteration: segsum (gather + segment sums), fast "
        "(scatter-free cumsum formulation) or v4 (static-routed "
        "bucketed layout with a host-side route build); auto picks "
        "from the backend and problem size",
    )
    p.add_argument(
        "--em-accel",
        choices=["none", "squarem"],
        default="none",
        help="EM acceleration: squarem runs squared-extrapolation "
        "cycles (same fixed point, typically 3-10x fewer m-steps on "
        "slow-mixing data; the reference's plain EM is the default)",
    )
    p.add_argument("--num-shards", type=int, default=0,
                   help="data-parallel device shards (0 = all local devices)")
    p.add_argument(
        "--coordinator", default=None,
        help="multi-host: coordinator address host:port for "
        "jax.distributed (env OARFISH_COORDINATOR); launch one process "
        "per host with matching --num-processes/--process-id",
    )
    p.add_argument(
        "--num-processes", type=int, default=None,
        help="multi-host: total process count (env OARFISH_NUM_PROCESSES)",
    )
    p.add_argument(
        "--process-id", type=int, default=None,
        help="multi-host: this process's id, 0-based "
        "(env OARFISH_PROCESS_ID)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile-dir", type=Path, default=None,
                   help="write a jax.profiler trace of the run here")
    return p


def _filter_value(v, default) -> FilterValue:
    return FilterValue(default, False) if v is None else FilterValue(v, True)


def to_args(ns: argparse.Namespace) -> Args:
    wap = None
    if ns.write_assignment_probs is not None:
        wap = ReadAssignmentProbOut.parse(ns.write_assignment_probs)
    return Args(
        alignments=ns.alignments,
        reads=ns.reads,
        annotated=ns.annotated,
        novel=ns.novel,
        index=ns.index,
        genome_alignments=ns.genome_alignments,
        genome=ns.genome,
        annotation=ns.annotation,
        genome_fasta=ns.genome_fasta,
        no_rescue=ns.no_rescue,
        junctions=ns.junctions,
        ignore_annotation_junctions=ns.ignore_annotation_junctions,
        only_index=ns.only_index,
        index_out=ns.index_out,
        seq_tech=ns.seq_tech,
        best_n=ns.best_n,
        dp_cache_cap_mb=ns.dp_cache_cap_mb,
        output=ns.output,
        quiet=ns.quiet,
        verbose=ns.verbose,
        filter_group=ns.filter_group,
        three_prime_clip=_filter_value(ns.three_prime_clip, U32_MAX),
        five_prime_clip=_filter_value(ns.five_prime_clip, U32_MAX),
        score_threshold=_filter_value(ns.score_threshold, 0.95),
        min_aligned_fraction=_filter_value(ns.min_aligned_fraction, 0.5),
        min_aligned_len=_filter_value(ns.min_aligned_len, 50),
        strand_filter=ns.strand_filter,
        score_prob_denom=ns.score_prob_denom,
        projected_prob_beta=ns.projected_prob_beta,
        projected_prob_source=ns.projected_prob_source,
        junc_miss_discount=ns.junc_miss_discount,
        single_cell=ns.single_cell,
        model_coverage=ns.model_coverage,
        growth_rate=ns.growth_rate,
        bin_width=ns.bin_width,
        write_assignment_probs=wap,
        display_thresh=ns.display_thresh,
        max_em_iter=ns.max_em_iter,
        convergence_thresh=ns.convergence_thresh,
        short_quant=ns.short_quant,
        num_bootstraps=ns.num_bootstraps,
        threads=ns.threads,
        sort_check_num=ns.sort_check_num,
        use_kde=ns.use_kde,
        em_dtype=ns.em_dtype,
        em_impl=ns.em_impl,
        em_accel=ns.em_accel,
        num_shards=ns.num_shards,
        coordinator=ns.coordinator,
        num_processes=ns.num_processes,
        process_id=ns.process_id,
        seed=ns.seed,
    )


def validate_modes(args: Args, parser: argparse.ArgumentParser) -> None:
    """Input-mode exclusivity and requirement rules
    (`prog_opts.rs:252-344,480-490`)."""
    inputs = [
        args.alignments is not None,
        args.reads is not None,
        args.only_index,
        args.genome_alignments is not None,
    ]
    if sum(inputs) != 1:
        parser.error(
            "exactly one of --alignments, --reads, --only-index, "
            "--genome-alignments is required"
        )
    if args.reads is not None:
        has_ref = any(
            x is not None
            for x in (args.annotated, args.novel, args.index, args.genome)
        )
        if not has_ref:
            parser.error(
                "--reads requires a reference: --annotated/--novel/--index "
                "or --genome"
            )
        if args.seq_tech is None:
            parser.error("--reads requires --seq-tech")
    if args.index is not None and (
        args.annotated is not None or args.novel is not None
    ):
        parser.error("--index conflicts with --annotated/--novel")
    if args.genome_alignments is not None and args.annotation is None:
        parser.error("--genome-alignments requires --annotation")
    if args.genome is not None and args.annotation is None:
        parser.error("--genome requires --annotation")
    if args.genome is not None and any(
        x is not None for x in (args.annotated, args.novel, args.index)
    ):
        parser.error("--genome conflicts with --annotated/--novel/--index")
    if args.single_cell:
        if args.alignments is None:
            parser.error("--single-cell requires --alignments")
        if args.write_assignment_probs is not None:
            parser.error("--write-assignment-probs conflicts with --single-cell")
    if args.only_index and args.index_out is None:
        parser.error("--only-index requires --index-out")
    if not args.only_index and args.output is None:
        parser.error("--output is required unless --only-index is given")


# Default persistent-compile-cache location: fixed and inside the
# checkout (the path is part of the cache key, so it must not move).
DEFAULT_JAX_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_persistent_jax_cache() -> None:
    """Enable JAX's persistent compilation cache, so a repeat run at the
    same shapes skips XLA compilation. Where JAX_COMPILATION_CACHE_DIR
    is set, JAX already uses that directory and it is left alone;
    otherwise the cache lives at DEFAULT_JAX_CACHE_DIR.
    OARFISH_JAX_CACHE=0 disables."""
    import os

    if os.environ.get("OARFISH_JAX_CACHE") == "0":
        return
    try:
        import jax

        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update(
                "jax_compilation_cache_dir", str(DEFAULT_JAX_CACHE_DIR)
            )
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    except Exception as e:  # noqa: BLE001 — cache is best-effort
        logging.getLogger("oarfish_tpu").debug(
            "persistent jax cache unavailable: %s", e
        )


def main(argv=None) -> int:
    import os

    enable_persistent_jax_cache()
    parser = build_parser()
    ns = parser.parse_args(argv)
    args = to_args(ns)
    validate_modes(args, parser)

    # multi-host launch: jax.distributed must initialize BEFORE any
    # backend use (env fallbacks let a launcher set these per host)
    coordinator = args.coordinator or os.environ.get("OARFISH_COORDINATOR")
    num_processes = args.num_processes or (
        int(os.environ["OARFISH_NUM_PROCESSES"])
        if os.environ.get("OARFISH_NUM_PROCESSES")
        else None
    )
    process_id = (
        args.process_id
        if args.process_id is not None
        else (
            int(os.environ["OARFISH_PROCESS_ID"])
            if os.environ.get("OARFISH_PROCESS_ID")
            else None
        )
    )
    if num_processes and num_processes > 1:
        from .parallel.multihost import initialize_distributed

        initialize_distributed(coordinator, num_processes, process_id)

    # per-process input sharding: a "{proc}" placeholder in the input
    # path resolves to this process's index, so each host packs only its
    # own shard of the reads (distributed ingest; the global CSR is the
    # disjoint union — inference merges per-transcript partials with the
    # same per-iteration psum)
    def _resolve_proc(p):
        if p is None or "{proc}" not in str(p):
            return p, False
        import jax

        pid = jax.process_index() if (num_processes or 0) > 1 else 0
        return type(p)(str(p).replace("{proc}", str(pid))), True

    args.alignments, sh_a = _resolve_proc(args.alignments)
    sh_r = False
    if args.reads:
        resolved = [_resolve_proc(p) for p in args.reads]
        args.reads = [p for p, _ in resolved]
        sh_r = any(s for _, s in resolved)
    if (sh_a or sh_r) and (num_processes or 0) > 1:
        args.sharded_inputs = True

    if ns.profile_dir is not None:
        # trace the whole run (the analogue of the reference's
        # tracing spans, SURVEY §5); view with tensorboard/xprof
        import contextlib

        import jax

        with contextlib.ExitStack() as stack:
            stack.enter_context(jax.profiler.trace(str(ns.profile_dir)))
            ns.profile_dir = None
            return main_inner(args, parser)
    return main_inner(args, parser)


def main_inner(args: Args, parser) -> int:

    level = logging.INFO
    if args.quiet:
        level = logging.WARNING
    if args.verbose:
        level = logging.DEBUG
    logging.basicConfig(
        level=level,
        stream=sys.stderr,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("oarfish_tpu")

    try:
        opts = resolve_filters(args)
    except ValueError as e:
        parser.error(str(e))

    if args.only_index:
        from .quant.raw_reads import only_index

        return only_index(args)
    if args.genome_alignments is not None:
        from .quant.genome import quantify_genome_alignments_from_bam

        quantify_genome_alignments_from_bam(args, opts)
        log.info("oarfish-tpu completed successfully.")
        return 0
    if args.genome is not None:
        from .quant.genome_reads import quantify_genome_raw_reads

        quantify_genome_raw_reads(args, opts)
        log.info("oarfish-tpu completed successfully.")
        return 0
    if args.reads is not None:
        from .quant.raw_reads import quantify_bulk_alignments_raw_reads

        quantify_bulk_alignments_raw_reads(args, opts)
        log.info("oarfish-tpu completed successfully.")
        return 0

    if args.single_cell:
        from .quant.single_cell import quantify_single_cell_from_collated_bam

        quantify_single_cell_from_collated_bam(args, opts)
    else:
        from .quant.bulk import quantify_bulk_alignments_from_bam

        quantify_bulk_alignments_from_bam(args, opts)

    log.info("oarfish-tpu completed successfully.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
