"""BGZF (blocked gzip) reading and writing.

The replacement for the reference's `noodles-bgzf` multithreaded
decoder (`Cargo.toml:62`, `main.rs:196-199,408-414`): BAM files are a series
of independent gzip members, each at most 64 KiB of payload, whose compressed
size is recorded in a `BC` extra subfield. Independent blocks mean inflation
parallelizes; `read_all` fans blocks out over a thread pool (zlib releases
the GIL). A native C++ inflate path can replace this transparently later.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

# The BGZF EOF marker: an empty gzip member every writer must terminate with.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_GZIP_MAGIC = b"\x1f\x8b"


def _scan_blocks(data: bytes) -> List[Tuple[int, int]]:
    """Return (offset, total_block_size) for every BGZF block in `data`."""
    blocks = []
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos : pos + 2] != _GZIP_MAGIC:
            raise ValueError(f"bad gzip magic at offset {pos}")
        flg = data[pos + 3]
        if not (flg & 0x04):
            raise ValueError("gzip member without FEXTRA; not a BGZF file")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        # walk the extra subfields for BC (contains BSIZE = block size - 1)
        xpos = pos + 12
        xend = xpos + xlen
        bsize = None
        while xpos + 4 <= xend:
            si1, si2, slen = data[xpos], data[xpos + 1], struct.unpack_from(
                "<H", data, xpos + 2
            )[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", data, xpos + 4)[0] + 1
            xpos += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block missing BC subfield")
        blocks.append((pos, bsize))
        pos += bsize
    return blocks


def _inflate_block(data: bytes, off: int, bsize: int) -> bytes:
    # Payload sits between the 12+XLEN byte header and the 8-byte CRC/ISIZE
    # trailer; it is a raw DEFLATE stream.
    xlen = struct.unpack_from("<H", data, off + 10)[0]
    comp = data[off + 12 + xlen : off + bsize - 8]
    return zlib.decompress(comp, wbits=-15)


def read_all(path, threads: int = 4) -> bytes:
    """Decompress an entire BGZF file, inflating blocks in parallel."""
    with open(path, "rb") as fh:
        data = fh.read()
    blocks = _scan_blocks(data)
    if threads <= 1 or len(blocks) < 4:
        return b"".join(_inflate_block(data, off, bs) for off, bs in blocks)
    with ThreadPoolExecutor(max_workers=threads) as ex:
        parts = list(ex.map(lambda b: _inflate_block(data, b[0], b[1]), blocks))
    return b"".join(parts)


def iter_decompressed(path, threads: int = 4, window: int = 64) -> Iterator[bytes]:
    """Stream decompressed payload chunks without holding the whole file's
    inflated contents in memory at once. `window` blocks are inflated in
    flight at a time."""
    with open(path, "rb") as fh:
        data = fh.read()
    blocks = _scan_blocks(data)
    if threads <= 1:
        for off, bs in blocks:
            part = _inflate_block(data, off, bs)
            if part:
                yield part
        return
    # a fresh pool per window: the generator may be abandoned mid-iteration
    # (e.g. a collation error aborts packing), and a pool held open across
    # yields would only be torn down by GC at interpreter shutdown
    for i in range(0, len(blocks), window):
        chunk = blocks[i : i + window]
        with ThreadPoolExecutor(max_workers=threads) as ex:
            parts = list(
                ex.map(lambda b: _inflate_block(data, b[0], b[1]), chunk)
            )
        for part in parts:
            if part:
                yield part


def compress_block(payload: bytes, level: int = 6) -> bytes:
    """Compress up to 64 KiB of payload into a single BGZF block."""
    assert len(payload) <= 0xFF00, "BGZF payload must be <= 65280 bytes"
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 12 + 6 + 8  # header + BC subfield + trailer
    header = (
        b"\x1f\x8b\x08\x04"  # magic, DEFLATE, FEXTRA
        + b"\x00\x00\x00\x00"  # mtime
        + b"\x00\xff"  # XFL, OS
        + struct.pack("<H", 6)  # XLEN
        + b"BC"
        + struct.pack("<H", 2)
        + struct.pack("<H", bsize - 1)
    )
    trailer = struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF)
    return header + comp + trailer


def write_bgzf(path, payload: bytes, level: int = 6) -> None:
    """Write `payload` as a BGZF file (blocked, with the EOF marker)."""
    with open(path, "wb") as fh:
        for i in range(0, len(payload), 0xFF00):
            fh.write(compress_block(payload[i : i + 0xFF00], level))
        fh.write(BGZF_EOF)
