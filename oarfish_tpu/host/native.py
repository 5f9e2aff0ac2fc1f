"""ctypes bindings for the C++ host decoder (csrc/bam_decoder.cpp).

Builds the shared library on first use if it is missing (g++ is part of
the image); falls back gracefully when unavailable so the pure-Python
reader keeps working.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ..io.bam import BamHeader
from .vector_filter import RecordColumns

log = logging.getLogger("oarfish_tpu")

_CSRC = Path(__file__).resolve().parent.parent.parent / "csrc"
_LIB_PATH = _CSRC / "liboarfish_host.so"
_lib = None
_lib_tried = False
_has_stream = False


class _Decoded(ctypes.Structure):
    _fields_ = [
        ("n_records", ctypes.c_int64),
        ("n_groups", ctypes.c_int64),
        ("n_refs", ctypes.c_int64),
        ("num_unmapped", ctypes.c_int64),
        ("group_id", ctypes.POINTER(ctypes.c_int64)),
        ("flag", ctypes.POINTER(ctypes.c_uint16)),
        ("ref_id", ctypes.POINTER(ctypes.c_int32)),
        ("pos", ctypes.POINTER(ctypes.c_int64)),
        ("ref_span", ctypes.POINTER(ctypes.c_int64)),
        ("seq_len", ctypes.POINTER(ctypes.c_int64)),
        ("score", ctypes.POINTER(ctypes.c_int64)),
        ("has_score", ctypes.POINTER(ctypes.c_uint8)),
        ("cb_id", ctypes.POINTER(ctypes.c_int64)),
        ("header_text", ctypes.c_char_p),
        ("header_text_len", ctypes.c_int64),
        ("ref_names", ctypes.POINTER(ctypes.c_char)),
        ("ref_names_len", ctypes.c_int64),
        ("ref_lengths", ctypes.POINTER(ctypes.c_int64)),
        ("group_names", ctypes.POINTER(ctypes.c_char)),
        ("group_names_len", ctypes.c_int64),
        ("barcodes", ctypes.POINTER(ctypes.c_char)),
        ("barcodes_len", ctypes.c_int64),
        ("n_barcodes", ctypes.c_int64),
        ("error", ctypes.c_char_p),
        ("dup_name", ctypes.c_char_p),
        ("is_final", ctypes.c_int64),
    ]


def _build_library() -> bool:
    """Build with libdeflate where it is installed; otherwise the source
    falls back to zlib's inflate (`__has_include`) and links without it."""
    src = _CSRC / "bam_decoder.cpp"
    if not src.exists():
        return False
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        str(src), "-o", str(_LIB_PATH), "-lz", "-pthread",
    ]
    err = None
    for extra in (["-ldeflate"], []):
        try:
            subprocess.run(cmd + extra, check=True, capture_output=True,
                           timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            err = e
            continue
        if not extra:
            log.warning("libdeflate unavailable: built the zlib-only "
                        "native decoder")
        return True
    log.warning("could not build native host decoder: %s", err)
    return False


def _lib_stale() -> bool:
    """True when the .so predates its source (rebuild after an edit)."""
    src = _CSRC / "bam_decoder.cpp"
    try:
        return src.exists() and src.stat().st_mtime > _LIB_PATH.stat().st_mtime
    except OSError:
        return False


def get_lib():
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if (not _LIB_PATH.exists() or _lib_stale()) and not _build_library():
        if not _LIB_PATH.exists():
            return None
        log.warning("rebuild of stale native decoder failed; using old .so")
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:
        log.warning("could not load native host decoder: %s", e)
        return None
    lib.oarfish_decode_bam.restype = ctypes.POINTER(_Decoded)
    lib.oarfish_decode_bam.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.oarfish_decoded_free.argtypes = [ctypes.POINTER(_Decoded)]
    global _has_stream
    try:  # an old prebuilt .so may predate the chunked stream API
        lib.oarfish_stream_open.restype = ctypes.c_void_p
        lib.oarfish_stream_open.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(_Decoded)),
        ]
        lib.oarfish_stream_next.restype = ctypes.POINTER(_Decoded)
        lib.oarfish_stream_next.argtypes = [ctypes.c_void_p]
        lib.oarfish_stream_close.argtypes = [ctypes.c_void_p]
        _has_stream = True
    except AttributeError:
        _has_stream = False
        log.warning("native decoder lacks the stream API; rebuild csrc")
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def _as_array(ptr, n, dtype):
    if n == 0 or not ptr:
        return np.empty(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).copy()


class NativeDecoded:
    """Columnar decode of a whole BAM, or one group-aligned chunk of a
    streamed decode (then `n_groups`/`is_final` matter and `header` is
    None except on the first chunk)."""

    def __init__(
        self,
        header: Optional[BamHeader],
        columns: RecordColumns,
        num_unmapped: int,
        group_names,
        dup_name,
        cb_id=None,
        barcodes=None,
        n_groups: int = 0,
        is_final: bool = True,
    ):
        self.header = header
        self.columns = columns
        self.num_unmapped = num_unmapped
        self.group_names = group_names
        self.dup_name = dup_name
        self.cb_id = cb_id
        self.barcodes = barcodes
        self.n_groups = n_groups
        self.is_final = is_final


def _unpack(d, path, keep_names: bool, want_barcodes: bool) -> NativeDecoded:
    """Convert one `_Decoded` struct (whole file or chunk) to numpy."""
    if d.error:
        raise ValueError(f"{path}: {d.error.decode(errors='replace')}")
    N = int(d.n_records)
    cols = RecordColumns(
        group_id=_as_array(d.group_id, N, np.int64),
        flag=_as_array(d.flag, N, np.uint16),
        ref_id=_as_array(d.ref_id, N, np.int32),
        pos=_as_array(d.pos, N, np.int64),
        ref_span=_as_array(d.ref_span, N, np.int64),
        seq_len=_as_array(d.seq_len, N, np.int64),
        score=_as_array(d.score, N, np.int64),
        has_score=_as_array(d.has_score, N, np.uint8).astype(bool),
    )
    header = None
    if d.header_text or d.n_refs:
        text = ctypes.string_at(d.header_text, d.header_text_len).decode(
            "utf-8", "replace"
        ).rstrip("\x00") if d.header_text_len else ""
        names_blob = ctypes.string_at(d.ref_names, d.ref_names_len) \
            if d.ref_names_len else b""
        ref_names = names_blob.decode().split("\x00")[: int(d.n_refs)]
        ref_lengths = list(_as_array(d.ref_lengths, int(d.n_refs), np.int64))
        header = BamHeader(text, ref_names, [int(x) for x in ref_lengths])
    group_names = None
    if keep_names and d.group_names_len:
        from .store import NameBlob

        blob = ctypes.string_at(d.group_names, d.group_names_len)
        # NUL-separated blob wrapped without a per-name Python list
        group_names = NameBlob.from_nul_blob(blob, int(d.n_groups))
    dup = d.dup_name.decode() if d.dup_name else None
    cb_id = None
    barcodes = None
    if want_barcodes:
        cb_id = _as_array(d.cb_id, N, np.int64)
        if d.barcodes_len:
            barcodes = ctypes.string_at(d.barcodes, d.barcodes_len).decode(
                errors="replace"
            ).split("\x00")[: int(d.n_barcodes)]
        else:
            barcodes = []
    return NativeDecoded(
        header,
        cols,
        int(d.num_unmapped),
        group_names,
        dup,
        cb_id,
        barcodes,
        n_groups=int(d.n_groups),
        is_final=bool(d.is_final),
    )


def decode_bam(
    path,
    threads: int = 4,
    keep_names: bool = False,
    sort_check_num: int = 100_000,
    want_barcodes: bool = False,
) -> Optional[NativeDecoded]:
    """Decode via the C++ library; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    dptr = lib.oarfish_decode_bam(
        str(path).encode(),
        int(threads),
        1 if keep_names else 0,
        int(sort_check_num),
        1 if want_barcodes else 0,
    )
    try:
        return _unpack(dptr.contents, path, keep_names, want_barcodes)
    finally:
        lib.oarfish_decoded_free(dptr)


def stream_bam(
    path,
    threads: int = 4,
    keep_names: bool = False,
    sort_check_num: int = 100_000,
    want_barcodes: bool = False,
):
    """Iterator of group-aligned `NativeDecoded` chunks via the C++
    stream API (chunk size follows the decode window,
    OARFISH_DECODE_WINDOW_MB). The first chunk carries the header; the
    last has `.is_final` (and the barcode table when requested). Group
    ids restart at 0 in every chunk — the consumer rebases. Returns None
    when the native library is unavailable; raises ValueError on a
    corrupt input."""
    lib = get_lib()
    if lib is None or not _has_stream:
        return None
    err = ctypes.POINTER(_Decoded)()
    h = lib.oarfish_stream_open(
        str(path).encode(),
        int(threads),
        1 if keep_names else 0,
        int(sort_check_num),
        1 if want_barcodes else 0,
        ctypes.byref(err),
    )
    if not h:
        msg = "stream open failed"
        if err:
            try:
                if err.contents.error:
                    msg = err.contents.error.decode(errors="replace")
            finally:
                lib.oarfish_decoded_free(err)
        raise ValueError(f"{path}: {msg}")

    def gen():
        try:
            while True:
                dptr = lib.oarfish_stream_next(h)
                try:
                    chunk = _unpack(
                        dptr.contents, path, keep_names, want_barcodes
                    )
                finally:
                    lib.oarfish_decoded_free(dptr)
                yield chunk
                if chunk.is_final:
                    return
        finally:
            lib.oarfish_stream_close(h)

    return gen()
