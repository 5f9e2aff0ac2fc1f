"""Minimal BAM model: header parsing, record decode, record iteration, and a
fixture writer.

Replacement for the reference's `noodles-bam`/`noodles-sam` record
model (`Cargo.toml:36-37`). Only the fields the quantifier consumes are
decoded: read name, flags, reference id, 1-based start/end (from the CIGAR
reference span), sequence length, the `AS` alignment-score tag, and the
`CB` cell-barcode tag. Header verification mirrors
`src/alignment_parser.rs:19-98`.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from . import bgzf

BAM_MAGIC = b"BAM\x01"

# SAM flags
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800

# CIGAR op codes (M I D N S H P = X); ops consuming the reference
CIGAR_OPS = "MIDNSHP=X"
_REF_CONSUMING = (True, False, True, True, False, False, False, True, True)
_READ_CONSUMING = (True, True, False, False, True, False, False, True, True)

KNOWN_MAPPERS = ("minimap2", "pbmm2", "bramble", "rammap")

I32_MIN = -(1 << 31)


class BamFormatError(ValueError):
    pass


@dataclass
class BamHeader:
    text: str
    ref_names: List[str]
    ref_lengths: List[int]

    @property
    def n_refs(self) -> int:
        return len(self.ref_names)

    def sort_order(self) -> Optional[str]:
        """The @HD SO: field, if present."""
        for line in self.text.splitlines():
            if line.startswith("@HD"):
                for fld in line.split("\t")[1:]:
                    if fld.startswith("SO:"):
                        return fld[3:]
                return None
        return None

    def programs(self) -> List[str]:
        """Root @PG program names (ID: with no PP: parent), mirroring
        `header.programs().roots()` in `alignment_parser.rs:66`."""
        progs = []
        for line in self.text.splitlines():
            if line.startswith("@PG"):
                fields = dict(
                    f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
                )
                if "PP" not in fields and "ID" in fields:
                    progs.append(fields["ID"])
        return progs


@dataclass
class BamRecord:
    """One alignment record, restricted to the fields the engine uses."""

    name: str
    flag: int
    ref_id: int  # -1 if unmapped to a reference
    pos: int  # 0-based leftmost coordinate
    ref_span: int  # reference bases consumed by the CIGAR
    seq_len: int
    score: Optional[int]  # AS tag
    barcode: Optional[bytes]  # CB tag
    cigar: Optional[List[Tuple[int, int]]] = None  # (len, op) when retained
    seq: Optional[bytes] = None  # reference-forward SEQ when retained

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    @property
    def aln_start(self) -> int:
        """1-based alignment start (noodles `alignment_start`)."""
        return self.pos + 1

    @property
    def aln_end(self) -> int:
        """1-based inclusive alignment end (noodles `alignment_end`)."""
        return self.pos + self.ref_span


def _parse_header_block(data: bytes) -> Tuple[BamHeader, int]:
    if data[:4] != BAM_MAGIC:
        raise BamFormatError("missing BAM magic")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8
    text = data[off : off + l_text].decode("utf-8", "replace").rstrip("\x00")
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    names, lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        names.append(data[off : off + l_name - 1].decode())
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        lengths.append(l_ref)
    return BamHeader(text, names, lengths), off


_TAG_SIZES = {
    ord("A"): 1,
    ord("c"): 1,
    ord("C"): 1,
    ord("s"): 2,
    ord("S"): 2,
    ord("i"): 4,
    ord("I"): 4,
    ord("f"): 4,
}
_TAG_FMT = {
    ord("c"): "<b",
    ord("C"): "<B",
    ord("s"): "<h",
    ord("S"): "<H",
    ord("i"): "<i",
    ord("I"): "<I",
}


def _parse_tags(buf: bytes, off: int, end: int):
    """Extract AS (int) and CB (string) from the aux-tag region."""
    score = None
    barcode = None
    while off + 3 <= end:
        t0, t1, vt = buf[off], buf[off + 1], buf[off + 2]
        off += 3
        if vt in _TAG_SIZES:
            if t0 == 0x41 and t1 == 0x53 and vt != ord("A") and vt != ord("f"):
                # AS:<int type>
                score = struct.unpack_from(_TAG_FMT[vt], buf, off)[0]
            off += _TAG_SIZES[vt]
        elif vt in (ord("Z"), ord("H")):
            zend = buf.index(0, off, end)
            if t0 == 0x43 and t1 == 0x42 and vt == ord("Z"):  # CB:Z
                barcode = buf[off:zend]
            off = zend + 1
        elif vt == ord("B"):
            sub = buf[off]
            (count,) = struct.unpack_from("<I", buf, off + 1)
            off += 5 + _TAG_SIZES[sub] * count
        else:
            raise BamFormatError(f"unknown tag value type {chr(vt)}")
    return score, barcode


_NIBBLE_STR = "=ACMGRSVTWYHKDBN"
_NIBBLE_TABLE = [
    (_NIBBLE_STR[hi] + _NIBBLE_STR[lo]).encode()
    for hi in range(16)
    for lo in range(16)
]


def decode_record(
    buf: bytes, keep_cigar: bool = False, keep_seq: bool = False
) -> BamRecord:
    """Decode one BAM record body (after the leading block_size)."""
    (
        ref_id,
        pos,
        l_read_name,
        _mapq,
        _bam_bin,
        n_cigar,
        flag,
        l_seq,
    ) = struct.unpack_from("<iiBBHHHi", buf, 0)
    off = 32
    name = buf[off : off + l_read_name - 1].decode()
    off += l_read_name
    ref_span = 0
    cigar = [] if keep_cigar else None
    for i in range(n_cigar):
        (c,) = struct.unpack_from("<I", buf, off + 4 * i)
        if _REF_CONSUMING[c & 0xF]:
            ref_span += c >> 4
        if keep_cigar:
            cigar.append((c >> 4, c & 0xF))
    off += 4 * n_cigar
    seq = None
    if keep_seq and l_seq:
        packed = buf[off : off + (l_seq + 1) // 2]
        seq = b"".join(_NIBBLE_TABLE[b] for b in packed)[:l_seq]
    off += (l_seq + 1) // 2  # packed sequence
    off += l_seq  # quality
    score, barcode = _parse_tags(buf, off, len(buf))
    return BamRecord(
        name, flag, ref_id, pos, ref_span, l_seq, score, barcode, cigar, seq
    )


class BamReader:
    """Streaming BAM reader over a multithreaded BGZF inflater."""

    def __init__(self, path, threads: int = 4):
        self.path = path
        self._chunks = bgzf.iter_decompressed(path, threads=threads)
        self._buf = bytearray()
        self._off = 0
        header_done = False
        # pull chunks until the full header block is buffered
        while not header_done:
            try:
                self._fill()
            except StopIteration:
                raise BamFormatError("truncated BAM header") from None
            try:
                self.header, consumed = _parse_header_block(bytes(self._buf))
                header_done = True
            except (struct.error, IndexError):
                continue
        self._off = consumed

    def _fill(self):
        self._buf.extend(next(self._chunks))

    def _compact(self):
        if self._off > (1 << 20):
            del self._buf[: self._off]
            self._off = 0

    def records(
        self, keep_cigar: bool = False, keep_seq: bool = False
    ) -> Iterator[BamRecord]:
        while True:
            while len(self._buf) - self._off < 4:
                try:
                    self._fill()
                except StopIteration:
                    if len(self._buf) - self._off not in (0,):
                        raise BamFormatError("truncated BAM record") from None
                    return
            (block_size,) = struct.unpack_from("<i", self._buf, self._off)
            while len(self._buf) - self._off < 4 + block_size:
                try:
                    self._fill()
                except StopIteration:
                    raise BamFormatError("truncated BAM record") from None
            start = self._off + 4
            rec = decode_record(
                bytes(self._buf[start : start + block_size]),
                keep_cigar,
                keep_seq,
            )
            self._off = start + block_size
            self._compact()
            yield rec


def verify_header(header: BamHeader, path, require_known_mapper: bool = True):
    """Reject coordinate-sorted BAMs and (in transcriptome mode) require a
    validated mapper in @PG (reference `alignment_parser.rs:19-98`)."""
    if header.sort_order() == "coordinate":
        raise BamFormatError(
            f"{path}: coordinate-sorted BAM is not supported; provide a BAM "
            "collated by record name (the natural minimap2 order)."
        )
    if require_known_mapper:
        progs = header.programs()
        if not any(p in KNOWN_MAPPERS for p in progs):
            raise BamFormatError(
                f"{path}: could not find a validated aligner in the BAM @PG "
                f"header. Recognized: {list(KNOWN_MAPPERS)}; saw: {progs}."
            )


# ---------------------------------------------------------------------------
# Fixture writer — used by tests and the synthetic benchmark generator. The
# reference repo bundles no BAM (`SURVEY.md` §4); we synthesize our own.
# ---------------------------------------------------------------------------

_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def _encode_record(
    name: str,
    flag: int,
    ref_id: int,
    pos: int,
    cigar: str,
    seq: str = "",
    score: Optional[int] = None,
    barcode: Optional[str] = None,
    mapq: int = 60,
) -> bytes:
    cig_ops = []
    for m in re.finditer(r"(\d+)([MIDNSHP=X])", cigar or ""):
        cig_ops.append((int(m.group(1)) << 4) | CIGAR_OPS.index(m.group(2)))
    nbytes = bytes([name.encode().__len__() + 1])
    body = bytearray()
    body += struct.pack(
        "<iiBBHHHiiii",
        ref_id,
        pos,
        len(name) + 1,
        mapq,
        0,
        len(cig_ops),
        flag,
        len(seq),
        -1,
        -1,
        0,
    )
    body += name.encode() + b"\x00"
    for c in cig_ops:
        body += struct.pack("<I", c)
    packed = bytearray()
    for i in range(0, len(seq), 2):
        hi = _SEQ_NIBBLE.get(seq[i].upper(), 15) << 4
        lo = _SEQ_NIBBLE.get(seq[i + 1].upper(), 15) if i + 1 < len(seq) else 0
        packed.append(hi | lo)
    body += bytes(packed)
    body += b"\xff" * len(seq)  # missing quality
    if score is not None:
        body += b"ASi" + struct.pack("<i", score)
    if barcode is not None:
        body += b"CBZ" + barcode.encode() + b"\x00"
    del nbytes
    return struct.pack("<i", len(body)) + bytes(body)


def write_bam(
    path,
    ref_names: List[str],
    ref_lengths: List[int],
    records: List[dict],
    program: str = "minimap2",
    sort_order: str = "unsorted",
) -> None:
    """Write a BAM file from record dicts (fixture/synthesis use only).

    Each record dict provides: name, flag, ref_id, pos (0-based), cigar,
    and optionally seq, score (AS), barcode (CB).
    """
    text = f"@HD\tVN:1.6\tSO:{sort_order}\n"
    for n, l in zip(ref_names, ref_lengths):
        text += f"@SQ\tSN:{n}\tLN:{l}\n"
    text += f"@PG\tID:{program}\tPN:{program}\n"
    payload = bytearray()
    payload += BAM_MAGIC
    tbytes = text.encode()
    payload += struct.pack("<i", len(tbytes)) + tbytes
    payload += struct.pack("<i", len(ref_names))
    for n, l in zip(ref_names, ref_lengths):
        nb = n.encode() + b"\x00"
        payload += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
    for rec in records:
        payload += _encode_record(**rec)
    bgzf.write_bgzf(path, bytes(payload))
