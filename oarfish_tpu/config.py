"""Run configuration: flags, filter groups, and filter resolution.

This is the equivalent of the reference's options layer
(`src/prog_opts.rs` and the filter-group overlay logic in
`src/main.rs:70-178`). The same defaults and override semantics are kept:
each filter flag remembers whether the user provided it explicitly, and a
`--filter-group` preset supplies baseline values that explicitly-provided
flags override.
"""

from __future__ import annotations

import enum
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


class Strand(enum.Enum):
    """Alignment-orientation filter (reference `prog_opts.rs:17-24`)."""

    FORWARD = "+"
    REVERSE = "-"
    BOTH = "."

    @staticmethod
    def parse(arg: str) -> "Strand":
        if arg in ("+", "fw", "FW", "f", "F"):
            return Strand.FORWARD
        if arg in ("-", "rc", "RC", "r", "R"):
            return Strand.REVERSE
        if arg in (".", "both", "either"):
            return Strand.BOTH
        raise ValueError(f"Cannot parse {arg} as a valid strand type")


class FilterGroup(enum.Enum):
    """Filter presets (reference `prog_opts.rs:12-15`)."""

    NO_FILTERS = "no-filters"
    NANOCOUNT_FILTERS = "nanocount-filters"


class SequencingTech(enum.Enum):
    """Raw-read mapping presets (reference `prog_opts.rs:87-109`)."""

    ONT_CDNA = "ont-cdna"
    ONT_DRNA = "ont-drna"
    PACBIO = "pacbio"
    PACBIO_HIFI = "pacbio-hifi"

    @staticmethod
    def parse(s: str) -> "SequencingTech":
        m = {
            "ont": SequencingTech.ONT_CDNA,
            "ont-cdna": SequencingTech.ONT_CDNA,
            "ont-drna": SequencingTech.ONT_DRNA,
            "pb": SequencingTech.PACBIO,
            "pacbio": SequencingTech.PACBIO,
            "pb-hifi": SequencingTech.PACBIO_HIFI,
            "pacbio-hifi": SequencingTech.PACBIO_HIFI,
        }
        try:
            return m[s.lower()]
        except KeyError:
            raise ValueError(f"Unknown protocol type {s}") from None


class ProjProbSource(enum.Enum):
    """Probability signal for projected (genome-mode) alignments
    (reference `prog_opts.rs:48-57`)."""

    SIMILARITY = "similarity"
    SCORE = "score"
    COMBINED = "combined"


class ReadAssignmentProbOut(enum.Enum):
    """`.prob` output compression (reference `prog_opts.rs:39-43`)."""

    UNCOMPRESSED = "uncompressed"
    COMPRESSED = "compressed"

    @staticmethod
    def parse(s: str) -> "ReadAssignmentProbOut":
        m = {
            "raw": ReadAssignmentProbOut.UNCOMPRESSED,
            "uncompressed": ReadAssignmentProbOut.UNCOMPRESSED,
            "compressed": ReadAssignmentProbOut.COMPRESSED,
            "lz4": ReadAssignmentProbOut.COMPRESSED,
        }
        try:
            return m[s.lower()]
        except KeyError:
            raise ValueError(
                f"Cannot parse {s} as a valid option for read assignment "
                "probability output"
            ) from None


def parse_display_thresh(s: str) -> float:
    """Parse --display-thresh; `none` maps to the smallest positive double
    (reference `prog_opts.rs:72-84`)."""
    if s.lower() == "none":
        return sys.float_info.min
    val = float(s)
    if not (0.0 <= val <= 1.0):
        raise ValueError(f"display-thresh must be between 0.0 and 1.0, got {val}")
    return val


U32_MAX = 0xFFFFFFFF
I64_MAX = (1 << 63) - 1


@dataclass
class FilterValue:
    """A filter flag value that remembers whether the user provided it
    (reference `prog_opts.rs:116-247`).  The reference round-trips defaults
    through ``*``-prefixed strings; here we simply carry a `provided` bit.
    """

    value: float
    provided: bool = False

    def provided_or(self, other):
        return self.value if self.provided else other


@dataclass
class FilterOpts:
    """Resolved alignment-filter parameters
    (reference `AlignmentFilters`, `oarfish_types.rs:763-806`)."""

    five_prime_clip: int = U32_MAX
    three_prime_clip: int = I64_MAX
    score_threshold: float = 0.95
    min_aligned_fraction: float = 0.5
    min_aligned_len: int = 50
    which_strand: Strand = Strand.BOTH
    model_coverage: bool = False
    logistic_growth_rate: float = 2.0
    write_assignment_probs: bool = False
    write_assignment_probs_type: Optional[ReadAssignmentProbOut] = None
    score_prob_denom: float = 5.0

    def to_json_dict(self) -> dict:
        """Serialization mirroring the reference's serde output of
        `AlignmentFilters` into meta_info.json (`bulk.rs:64`)."""
        strand_names = {
            Strand.FORWARD: "Forward",
            Strand.REVERSE: "Reverse",
            Strand.BOTH: "Unknown",
        }
        out_type = None
        if self.write_assignment_probs_type is not None:
            out_type = (
                "Uncompressed"
                if self.write_assignment_probs_type
                == ReadAssignmentProbOut.UNCOMPRESSED
                else "Compressed"
            )
        return {
            "five_prime_clip": self.five_prime_clip,
            "three_prime_clip": self.three_prime_clip,
            "score_threshold": self.score_threshold,
            "min_aligned_fraction": self.min_aligned_fraction,
            "min_aligned_len": self.min_aligned_len,
            "which_strand": strand_names[self.which_strand],
            "model_coverage": self.model_coverage,
            "logistic_growth_rate": self.logistic_growth_rate,
            "write_assignment_probs": self.write_assignment_probs,
            "write_assignment_probs_type": out_type,
            "score_prob_denom": self.score_prob_denom,
        }


@dataclass
class Args:
    """The full flag surface (reference `Args`, `prog_opts.rs:250-566`),
    with identical defaults."""

    # input modes
    alignments: Optional[Path] = None
    reads: Optional[list] = None
    annotated: Optional[Path] = None
    novel: Optional[Path] = None
    index: Optional[Path] = None
    genome_alignments: Optional[Path] = None
    genome: Optional[Path] = None
    annotation: Optional[Path] = None
    genome_fasta: Optional[Path] = None
    no_rescue: bool = False
    junctions: Optional[Path] = None
    ignore_annotation_junctions: bool = False
    only_index: bool = False
    index_out: Optional[Path] = None
    seq_tech: Optional[SequencingTech] = None
    best_n: int = 100
    dp_cache_cap_mb: Optional[int] = None

    # output
    output: Optional[Path] = None

    # logging
    quiet: bool = False
    verbose: bool = False

    # filters (defaults from prog_opts.rs:449-478)
    filter_group: Optional[FilterGroup] = None
    three_prime_clip: FilterValue = field(
        default_factory=lambda: FilterValue(U32_MAX, False)
    )
    five_prime_clip: FilterValue = field(
        default_factory=lambda: FilterValue(U32_MAX, False)
    )
    score_threshold: FilterValue = field(
        default_factory=lambda: FilterValue(0.95, False)
    )
    min_aligned_fraction: FilterValue = field(
        default_factory=lambda: FilterValue(0.5, False)
    )
    min_aligned_len: FilterValue = field(default_factory=lambda: FilterValue(50, False))
    strand_filter: Strand = Strand.BOTH
    score_prob_denom: Optional[float] = None

    # genome-mode knobs
    projected_prob_beta: float = 10.0
    projected_prob_source: ProjProbSource = ProjProbSource.SIMILARITY
    junc_miss_discount: float = 1.0

    # modes
    single_cell: bool = False

    # coverage model
    model_coverage: bool = False
    growth_rate: float = 2.0
    bin_width: int = 100

    # probability output
    write_assignment_probs: Optional[ReadAssignmentProbOut] = None
    display_thresh: float = 1e-6

    # EM
    max_em_iter: int = 1000
    convergence_thresh: float = 1e-3
    short_quant: Optional[str] = None
    num_bootstraps: int = 0

    # execution
    threads: int = 3
    sort_check_num: int = 100_000
    use_kde: bool = False

    # Extensions (no reference equivalent): compute precision of
    # the device EM, EM kernel implementation, data-parallel shard count.
    em_dtype: str = "float64"
    em_impl: str = "auto"  # auto | segsum | fast
    em_accel: str = "none"  # none | squarem
    num_shards: int = 0  # 0 => use all local devices
    # multi-host launch (jax.distributed): one CLI process per host
    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # True when the input path contained "{proc}": each process packed
    # only ITS shard of the reads (distributed ingest) — the global CSR
    # is the disjoint union across processes
    sharded_inputs: bool = False
    seed: int = 0


def resolve_filters(args: Args) -> FilterOpts:
    """Resolve the filter-group preset + explicit overrides into concrete
    filter options (reference `get_filter_opts`, `main.rs:70-178`)."""
    if args.score_prob_denom is not None and (
        args.genome is not None or args.genome_alignments is not None
    ):
        raise ValueError(
            "--score-prob-denom does not apply in genome (projection) mode"
        )

    common = dict(
        model_coverage=args.model_coverage,
        logistic_growth_rate=args.growth_rate,
        write_assignment_probs=args.write_assignment_probs is not None,
        write_assignment_probs_type=args.write_assignment_probs,
        score_prob_denom=(
            args.score_prob_denom if args.score_prob_denom is not None else 5.0
        ),
    )

    if args.filter_group == FilterGroup.NO_FILTERS:
        return FilterOpts(
            five_prime_clip=int(args.five_prime_clip.provided_or(U32_MAX)),
            three_prime_clip=int(args.three_prime_clip.provided_or(I64_MAX)),
            score_threshold=float(args.score_threshold.provided_or(0.0)),
            min_aligned_fraction=float(args.min_aligned_fraction.provided_or(0.0)),
            min_aligned_len=int(args.min_aligned_len.provided_or(1)),
            which_strand=args.strand_filter,
            **common,
        )
    if args.filter_group == FilterGroup.NANOCOUNT_FILTERS:
        return FilterOpts(
            five_prime_clip=int(args.five_prime_clip.provided_or(U32_MAX)),
            three_prime_clip=int(args.three_prime_clip.provided_or(50)),
            score_threshold=float(args.score_threshold.provided_or(0.95)),
            min_aligned_fraction=float(args.min_aligned_fraction.provided_or(0.5)),
            min_aligned_len=int(args.min_aligned_len.provided_or(50)),
            which_strand=Strand.FORWARD,
            **common,
        )
    return FilterOpts(
        five_prime_clip=int(args.five_prime_clip.value),
        three_prime_clip=int(args.three_prime_clip.value),
        score_threshold=float(args.score_threshold.value),
        min_aligned_fraction=float(args.min_aligned_fraction.value),
        min_aligned_len=int(args.min_aligned_len.value),
        which_strand=args.strand_filter,
        **common,
    )
