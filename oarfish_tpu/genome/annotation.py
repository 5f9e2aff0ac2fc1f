"""GTF/GFF transcript-model loading.

Equivalent of `bramble_rs::annotation::load_transcripts` (used at
reference `projection.rs:45-55`, `main.rs:252`): parse exon features from a
GTF or GFF3 annotation into per-transcript exon chains, in annotation
order (transcript ids are dense indices in first-appearance order — the
same invariant the reference relies on, `projection.rs:11-14`).

Coordinates: GTF/GFF exon lines are 1-based inclusive; exons are stored
that way (start, end) and sorted by genomic start within a transcript.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Transcript:
    id: str
    seqname: str
    strand: str  # '+', '-', '.'
    exons: List[Tuple[int, int]] = field(default_factory=list)  # 1-based incl

    @property
    def exonic_length(self) -> int:
        return sum(e - s + 1 for s, e in self.exons)

    @property
    def span(self) -> Tuple[int, int]:
        return self.exons[0][0], self.exons[-1][1]


_GTF_TID = re.compile(r'transcript_id "([^"]+)"')
_GFF_ATTR = re.compile(r"(?:^|;)\s*(Parent|transcript_id|ID)=([^;]+)")


def _open(path):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def _gtf_transcript_id(attrs: str) -> Optional[str]:
    m = _GTF_TID.search(attrs)
    return m.group(1) if m else None


def _gff_transcript_id(attrs: str) -> Optional[str]:
    # exon features reference their transcript via Parent=; strip any
    # "transcript:" prefix Ensembl-style
    vals = dict(m.groups() for m in _GFF_ATTR.finditer(attrs))
    tid = vals.get("Parent") or vals.get("transcript_id") or vals.get("ID")
    if tid is None:
        return None
    tid = tid.split(",")[0]
    if ":" in tid:
        tid = tid.split(":", 1)[1]
    return tid


def load_transcripts(path) -> List[Transcript]:
    """Parse exon features; transcripts ordered by first appearance."""
    by_id: Dict[str, Transcript] = {}
    order: List[str] = []
    is_gff = str(path).rstrip(".gz").endswith((".gff", ".gff3"))
    with _open(path) as fh:
        for line in fh:
            if not line or line[0] == "#":
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 9 or f[2] != "exon":
                continue
            tid = (
                _gff_transcript_id(f[8]) if is_gff else _gtf_transcript_id(f[8])
            )
            if tid is None:
                # fall back to the other convention before giving up
                tid = (
                    _gtf_transcript_id(f[8])
                    if is_gff
                    else _gff_transcript_id(f[8])
                )
            if tid is None:
                continue
            tx = by_id.get(tid)
            if tx is None:
                tx = Transcript(tid, f[0], f[6] if f[6] in "+-" else ".")
                by_id[tid] = tx
                order.append(tid)
            tx.exons.append((int(f[3]), int(f[4])))
    out = []
    for tid in order:
        tx = by_id[tid]
        tx.exons.sort()
        out.append(tx)
    return out


def write_annotation_junction_bed(transcripts: List[Transcript], path) -> int:
    """BED12 of multi-exon transcript models for splice-junction hinting
    (`projection.rs:86-140`). Returns the number written."""
    n = 0
    with open(path, "w") as w:
        for tx in transcripts:
            if len(tx.exons) < 2:
                continue
            # BED 0-based half-open blocks
            exons = sorted((max(s - 1, 0), e) for s, e in tx.exons)
            chrom_start = exons[0][0]
            chrom_end = exons[-1][1]
            sizes = "".join(f"{e - s}," for s, e in exons)
            starts = "".join(f"{s - chrom_start}," for s, _ in exons)
            strand = tx.strand if tx.strand in "+-" else "."
            w.write(
                f"{tx.seqname}\t{chrom_start}\t{chrom_end}\t{tx.id}\t1000\t"
                f"{strand}\t{chrom_start}\t{chrom_end}\t0\t{len(exons)}\t"
                f"{sizes}\t{starts}\n"
            )
            n += 1
    return n


def junctions_from_transcripts(transcripts: List[Transcript]) -> dict:
    """Per-chromosome intron intervals (donor, acceptor), 0-based
    half-open, from multi-exon transcript models — the junction set the
    reference derives for spliced-alignment hinting (`main.rs:255-281`)."""
    juncs: dict = {}
    for tx in transcripts:
        if len(tx.exons) < 2:
            continue
        exons = sorted((max(s - 1, 0), e) for s, e in tx.exons)
        lst = juncs.setdefault(tx.seqname, set())
        for (s0, e0), (s1, e1) in zip(exons, exons[1:]):
            if s1 > e0:
                lst.add((e0, s1))
    return {c: sorted(v) for c, v in juncs.items()}


def read_junction_bed(path) -> dict:
    """Parse a BED12 of transcript models (as written by
    `write_annotation_junction_bed` / accepted by `--junctions`,
    `prog_opts.rs:366-371`) into per-chromosome intron intervals."""
    juncs: dict = {}
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith(("#", "track", "browser")):
                continue
            f = line.split("\t")
            if len(f) < 12:
                continue
            chrom = f[0]
            start = int(f[1])
            sizes = [int(x) for x in f[10].rstrip(",").split(",") if x]
            starts = [int(x) for x in f[11].rstrip(",").split(",") if x]
            lst = juncs.setdefault(chrom, set())
            for i in range(len(starts) - 1):
                donor = start + starts[i] + sizes[i]
                acceptor = start + starts[i + 1]
                if acceptor > donor:
                    lst.add((donor, acceptor))
    return {c: sorted(v) for c, v in juncs.items()}
