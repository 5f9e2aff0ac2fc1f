"""Genome→transcriptome index: exon chains + a binned genomic interval
index for candidate-transcript lookup.

Equivalent of bramble's `G2TTree` (`projection.rs:45-74`): each
transcript gets a dense 0-based id in annotation order; lookups map a
genomic span on a chromosome to the transcripts whose exonic extent
overlaps it. The transcriptome header/`TranscriptInfo` are built in this
id order so projected `transcript_id`s index them directly
(`projection.rs:148-206`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .annotation import Transcript

BIN_SHIFT = 14  # 16 kb genome bins


@dataclass
class TxModel:
    tid: int
    name: str
    strand: str
    chrom_id: int
    exon_starts: np.ndarray  # 1-based, sorted
    exon_ends: np.ndarray  # 1-based inclusive
    # cumulative exonic length before each exon (genomic order)
    cum_before: np.ndarray
    length: int  # exonic length (>= 1 after padding)

    def span(self) -> Tuple[int, int]:
        return int(self.exon_starts[0]), int(self.exon_ends[-1])

    def to_txp_coord(self, g: int) -> Optional[int]:
        """Map a genomic position (1-based, exonic) to the 1-based
        transcript coordinate; None if `g` is intronic/outside."""
        i = int(np.searchsorted(self.exon_starts, g, side="right")) - 1
        if i < 0 or g > self.exon_ends[i]:
            return None
        fwd = int(self.cum_before[i]) + (g - int(self.exon_starts[i]))  # 0-based
        if self.strand == "-":
            return self.length - fwd
        return fwd + 1


class G2TIndex:
    def __init__(self, transcripts: Sequence[Transcript], refnames: Sequence[str]):
        chrom_of = {name: i for i, name in enumerate(refnames)}
        self.refnames = list(refnames)
        self.models: List[TxModel] = []
        self.names: List[str] = []
        # per chromosome: dict bin -> list of tids
        self._bins: List[Dict[int, List[int]]] = [dict() for _ in refnames]
        n_skipped = 0
        for tx in transcripts:
            cid = chrom_of.get(tx.seqname)
            tid = len(self.models)
            if cid is None or not tx.exons:
                # keep id-alignment with annotation order, like the
                # reference keeps zero-length transcripts at length 1
                n_skipped += 1
                starts = np.asarray([1], dtype=np.int64)
                ends = np.asarray([0], dtype=np.int64)
                model = TxModel(
                    tid, tx.id, tx.strand, -1 if cid is None else cid,
                    starts, ends, np.asarray([0], dtype=np.int64), 1,
                )
                self.models.append(model)
                self.names.append(tx.id)
                continue
            starts = np.asarray([s for s, _ in tx.exons], dtype=np.int64)
            ends = np.asarray([e for _, e in tx.exons], dtype=np.int64)
            lens = ends - starts + 1
            cum = np.zeros(len(lens), dtype=np.int64)
            np.cumsum(lens[:-1], out=cum[1:])
            length = int(lens.sum())
            model = TxModel(
                tid, tx.id, tx.strand, cid, starts, ends, cum, max(length, 1)
            )
            self.models.append(model)
            self.names.append(tx.id)
            for b in range(
                int(starts[0]) >> BIN_SHIFT, (int(ends[-1]) >> BIN_SHIFT) + 1
            ):
                self._bins[cid].setdefault(b, []).append(tid)
        self.n_unplaced = n_skipped

    @property
    def num_transcripts(self) -> int:
        return len(self.models)

    def transcript_lengths(self) -> np.ndarray:
        return np.asarray([m.length for m in self.models], dtype=np.int64)

    def candidates(self, chrom_id: int, gstart: int, gend: int) -> List[int]:
        """tids whose exonic extent may overlap [gstart, gend] (1-based)."""
        if chrom_id < 0 or chrom_id >= len(self._bins):
            return []
        bins = self._bins[chrom_id]
        out: List[int] = []
        seen = set()
        for b in range(gstart >> BIN_SHIFT, (gend >> BIN_SHIFT) + 1):
            for tid in bins.get(b, ()):
                if tid not in seen:
                    seen.add(tid)
                    m = self.models[tid]
                    s, e = m.span()
                    if s <= gend and e >= gstart:
                        out.append(tid)
        return out
