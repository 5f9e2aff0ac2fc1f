"""Minimal stdlib-only Parquet writer for Float64 column tables.

Writes exactly the layout `.infreps.pq` needs: one row group; per column
one nullable DOUBLE column chunk holding a single data page v2 with
PLAIN-encoded values, GZIP-compressed (RFC 1952), and RLE definition
levels (no nulls). Metadata is Thrift compact protocol, as the Parquet
format specification (parquet.thrift) defines it.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Dict

import numpy as np

# parquet.thrift enum values
_DOUBLE = 5  # Type
_OPTIONAL = 1  # FieldRepetitionType
_PLAIN, _RLE = 0, 3  # Encoding
_GZIP = 2  # CompressionCodec
_DATA_PAGE_V2 = 3  # PageType

# Thrift compact protocol field types
_T_I32, _T_I64, _T_BINARY, _T_LIST, _T_STRUCT = 5, 6, 8, 9, 12
_T_TRUE, _T_FALSE = 1, 2


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(n: int) -> bytes:
    return _varint((n << 1) ^ (n >> 63))


class _Struct:
    """Compact-protocol struct encoder: fields must be added in
    increasing id order."""

    def __init__(self):
        self.buf = bytearray()
        self.last = 0

    def _head(self, fid: int, ftype: int) -> None:
        delta = fid - self.last
        if 0 < delta <= 15:
            self.buf.append((delta << 4) | ftype)
        else:
            self.buf.append(ftype)
            self.buf += _zigzag(fid)
        self.last = fid

    def i32(self, fid: int, v: int) -> "_Struct":
        self._head(fid, _T_I32)
        self.buf += _zigzag(v)
        return self

    def i64(self, fid: int, v: int) -> "_Struct":
        self._head(fid, _T_I64)
        self.buf += _zigzag(v)
        return self

    def string(self, fid: int, v: str) -> "_Struct":
        b = v.encode()
        self._head(fid, _T_BINARY)
        self.buf += _varint(len(b)) + b
        return self

    def boolean(self, fid: int, v: bool) -> "_Struct":
        self._head(fid, _T_TRUE if v else _T_FALSE)
        return self

    def struct(self, fid: int, s: "_Struct") -> "_Struct":
        self._head(fid, _T_STRUCT)
        self.buf += s.end()
        return self

    def list(self, fid: int, etype: int, items) -> "_Struct":
        self._head(fid, _T_LIST)
        n = len(items)
        if n < 15:
            self.buf.append((n << 4) | etype)
        else:
            self.buf.append(0xF0 | etype)
            self.buf += _varint(n)
        for it in items:
            if etype == _T_STRUCT:
                self.buf += it.end()
            elif etype == _T_BINARY:
                b = it.encode()
                self.buf += _varint(len(b)) + b
            else:  # i32
                self.buf += _zigzag(it)
        return self

    def end(self) -> bytes:
        return bytes(self.buf) + b"\x00"


def write_float64_table(path: Path, columns: Dict[str, np.ndarray]) -> None:
    """Write equal-length float64 columns, in the given order, as one
    row group."""
    names = list(columns)
    n_rows = len(columns[names[0]]) if names else 0
    out = bytearray(b"PAR1")
    chunks = []
    total = 0
    # definition levels: one RLE run of n_rows ones (bit width 1, no
    # length prefix in a v2 page)
    def_levels = _varint(n_rows << 1) + b"\x01" if n_rows else b""
    for name in names:
        vals = np.ascontiguousarray(columns[name], dtype="<f8")
        if len(vals) != n_rows:
            raise ValueError(f"column {name!r} has {len(vals)} rows, "
                             f"expected {n_rows}")
        comp = gzip.compress(vals.tobytes(), mtime=0)
        page = (
            _Struct()
            .i32(1, _DATA_PAGE_V2)
            .i32(2, len(def_levels) + vals.nbytes)
            .i32(3, len(def_levels) + len(comp))
            .struct(8, _Struct()
                    .i32(1, n_rows).i32(2, 0).i32(3, n_rows)
                    .i32(4, _PLAIN).i32(5, len(def_levels)).i32(6, 0)
                    .boolean(7, True))
            .end()
        )
        offset = len(out)
        out += page + def_levels + comp
        unc = len(page) + len(def_levels) + vals.nbytes
        cmp_ = len(page) + len(def_levels) + len(comp)
        total += unc
        meta = (
            _Struct()
            .i32(1, _DOUBLE)
            .list(2, _T_I32, [_PLAIN, _RLE])
            .list(3, _T_BINARY, [name])
            .i32(4, _GZIP)
            .i64(5, n_rows)
            .i64(6, unc)
            .i64(7, cmp_)
            .i64(9, offset)
        )
        chunks.append(_Struct().i64(2, offset).struct(3, meta))
    schema = [_Struct().string(4, "schema").i32(5, len(names))]
    schema += [
        _Struct().i32(1, _DOUBLE).i32(3, _OPTIONAL).string(4, name)
        for name in names
    ]
    row_group = (
        _Struct().list(1, _T_STRUCT, chunks).i64(2, total).i64(3, n_rows)
    )
    footer = (
        _Struct()
        .i32(1, 2)
        .list(2, _T_STRUCT, schema)
        .i64(3, n_rows)
        .list(4, _T_STRUCT, [row_group])
        .string(6, "oarfish_tpu")
        .end()
    )
    out += footer + struct.pack("<I", len(footer)) + b"PAR1"
    with open(path, "wb") as fh:
        fh.write(out)
