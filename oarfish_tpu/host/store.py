"""The CSR alignment store and per-transcript coverage state.

Equivalent of `InMemoryAlignmentStore` + `TranscriptInfo`
(`oarfish_types.rs:547-759`, `:430-545`): for every retained read a
contiguous slice of alignments with parallel probability arrays, delimited
by a `boundaries` offsets vector. Here the store is a set of flat numpy
arrays ready to ship to device HBM, and coverage binning
(`TranscriptInfo::add_interval`, `oarfish_types.rs:496-538`) is a
vectorized pass instead of a per-record scalar loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .filters import DiscardTable, FilteredGroup

_cov_lib = None
_cov_tried = False


def _get_cov_lib():
    """ctypes handle to the native coverage accumulator (built on first
    use from csrc/coverage.cpp; None if the toolchain is unavailable)."""
    global _cov_lib, _cov_tried
    if _cov_lib is not None or _cov_tried:
        return _cov_lib
    _cov_tried = True
    import ctypes
    import subprocess
    from pathlib import Path

    csrc = Path(__file__).resolve().parent.parent.parent / "csrc"
    src = csrc / "coverage.cpp"
    so = csrc / "liboarfish_coverage.so"
    if not so.exists() or (
        src.exists() and src.stat().st_mtime > so.stat().st_mtime
    ):
        try:
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                 str(src), "-o", str(so), "-pthread"],
                check=True, capture_output=True, timeout=180,
            )
        except Exception:  # noqa: BLE001
            if not so.exists():
                return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    p64 = ctypes.POINTER(ctypes.c_int64)
    pd = ctypes.POINTER(ctypes.c_double)
    lib.oarfish_coverage_add.argtypes = [
        p64, p64, p64, ctypes.c_int64, pd, p64, p64, pd,
        ctypes.c_int64, ctypes.c_int64, pd, pd, ctypes.c_int,
    ]
    try:  # persistent-accumulator API (absent in a stale prebuilt .so)
        lib.oarfish_cov_acc_new.restype = ctypes.c_void_p
        lib.oarfish_cov_acc_new.argtypes = [
            ctypes.c_int64, ctypes.c_int64, pd, p64, p64, pd, ctypes.c_int,
        ]
        lib.oarfish_cov_acc_add.argtypes = [
            ctypes.c_void_p, p64, p64, p64, ctypes.c_int64,
        ]
        lib.oarfish_cov_acc_finish.argtypes = [ctypes.c_void_p, pd, pd]
        lib.oarfish_cov_acc_abort.argtypes = [ctypes.c_void_p]
        lib._has_acc = True
    except AttributeError:
        lib._has_acc = False
    _cov_lib = lib
    return lib


def _rust_round(x: np.ndarray) -> np.ndarray:
    """Rust f64::round = round half away from zero (numpy rounds half to
    even, which differs on exact .5 values — parity-critical for the
    `bin_width` recomputation at `oarfish_types.rs:475,501`)."""
    return np.floor(np.abs(x) + 0.5) * np.sign(x)


class TranscriptCoverage:
    """Per-transcript coverage-bin accumulators (ragged, CSR over
    transcripts). `bin_width == 0` means the coverage model is off and no
    bins are kept (matching `TranscriptInfo::with_len`, which still holds a
    10-bin placeholder the model never reads)."""

    def __init__(self, txp_len: np.ndarray, bin_width: int):
        self.txp_len = np.asarray(txp_len, dtype=np.int64)
        self.lenf = self.txp_len.astype(np.float64)
        self.bin_width = int(bin_width)
        T = len(self.txp_len)
        if bin_width > 0:
            # nbins = ceil(len / bin_width)  (`oarfish_types.rs:464`)
            self.nbins = np.ceil(self.lenf / float(bin_width)).astype(np.int64)
        else:
            self.nbins = np.full(T, 10, dtype=np.int64)
        self.bin_offsets = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(self.nbins, out=self.bin_offsets[1:])
        self.bins = np.zeros(int(self.bin_offsets[-1]), dtype=np.float64)
        self.total_weight = np.zeros(T, dtype=np.float64)
        # rounded per-transcript bin width used inside add_interval
        # (`oarfish_types.rs:501`: bin_width = round(tlen / num_intervals))
        self.rbw = _rust_round(self.lenf / self.nbins.astype(np.float64))
        self._acc = None  # native accumulator session (begin_accumulation)

    def begin_accumulation(self, threads: int = 8) -> bool:
        """Open a persistent native accumulator session for chunked
        packing: per-thread partial-bin arrays are allocated once and
        merged once at `finish_accumulation`, instead of per
        `add_intervals` call (which cost ~5s of zero+merge over 16
        chunks at 14M bins). Returns True when the native session is
        active; False falls back to per-call accumulation."""
        if self.bin_width <= 0 or self._acc is not None:
            return self._acc is not None
        lib = _get_cov_lib()
        if lib is None or not getattr(lib, "_has_acc", False):
            return False
        import ctypes

        p64 = ctypes.POINTER(ctypes.c_int64)
        pd = ctypes.POINTER(ctypes.c_double)
        h = lib.oarfish_cov_acc_new(
            len(self.txp_len), len(self.bins),
            self.lenf.ctypes.data_as(pd),
            self.nbins.ctypes.data_as(p64),
            self.bin_offsets.ctypes.data_as(p64),
            self.rbw.ctypes.data_as(pd),
            int(threads),
        )
        if not h:
            return False
        self._acc = (lib, h)
        return True

    def finish_accumulation(self) -> None:
        """Merge the native session's partials into bins/total_weight
        and close it. No-op when no session is open."""
        if self._acc is None:
            return
        import ctypes

        lib, h = self._acc
        self._acc = None
        pd = ctypes.POINTER(ctypes.c_double)
        lib.oarfish_cov_acc_finish(
            h, self.bins.ctypes.data_as(pd),
            self.total_weight.ctypes.data_as(pd),
        )

    def abort_accumulation(self) -> None:
        """Free the native session without merging (error paths)."""
        if self._acc is None:
            return
        lib, h = self._acc
        self._acc = None
        lib.oarfish_cov_acc_abort(h)

    def add_intervals(
        self, tid: np.ndarray, start: np.ndarray, end: np.ndarray,
        threads: int = 8,
    ) -> None:
        """Vectorized `add_interval(start, end, 1.0)` over many alignments
        (`oarfish_types.rs:496-538`). Uses the native accumulator
        (csrc/coverage.cpp) when available; the NumPy path below is the
        differential oracle and fallback."""
        tid = np.asarray(tid, dtype=np.int64)
        if tid.size == 0:
            return
        if self._acc is not None:
            import ctypes

            p64 = ctypes.POINTER(ctypes.c_int64)
            lib, h = self._acc
            s64 = np.ascontiguousarray(start, dtype=np.int64)
            e64 = np.ascontiguousarray(end, dtype=np.int64)
            lib.oarfish_cov_acc_add(
                h,
                tid.ctypes.data_as(p64),
                s64.ctypes.data_as(p64),
                e64.ctypes.data_as(p64),
                len(tid),
            )
            return
        if self.bin_width > 0:
            lib = _get_cov_lib()
            if lib is not None:
                import ctypes

                p64 = ctypes.POINTER(ctypes.c_int64)
                pd = ctypes.POINTER(ctypes.c_double)
                s64 = np.ascontiguousarray(start, dtype=np.int64)
                e64 = np.ascontiguousarray(end, dtype=np.int64)
                lib.oarfish_coverage_add(
                    tid.ctypes.data_as(p64),
                    s64.ctypes.data_as(p64),
                    e64.ctypes.data_as(p64),
                    len(tid),
                    self.lenf.ctypes.data_as(pd),
                    self.nbins.ctypes.data_as(p64),
                    self.bin_offsets.ctypes.data_as(p64),
                    self.rbw.ctypes.data_as(pd),
                    len(self.txp_len),
                    len(self.bins),
                    self.bins.ctypes.data_as(pd),
                    self.total_weight.ctypes.data_as(pd),
                    int(threads),
                )
                return
        if tid.size * 16 < len(self.total_weight):
            # small group: O(group) scatter-add — a full-T bincount per
            # read group cost ~0.5ms/read at T=250k (genome mode calls
            # this once per read; ~37s of a GENCODE-scale run)
            np.add.at(self.total_weight, tid, 1.0)
        else:
            self.total_weight += np.bincount(
                tid, minlength=len(self.total_weight)
            )
        if self.bin_width == 0:
            # coverage model off: the reference keeps a 10-bin placeholder
            # the model never reads (`TranscriptInfo::with_len`); skip the
            # binning work entirely (no consumer reads `bins` then)
            return
        start = np.asarray(start, dtype=np.float64)
        end = np.asarray(end, dtype=np.float64)
        s = np.minimum(start, end)
        e = np.maximum(s, end)

        tlen = self.lenf[tid]
        nb = self.nbins[tid].astype(np.float64)
        start_bin = np.floor(s / tlen * nb).astype(np.int64)
        end_bin = np.floor(e / tlen * nb).astype(np.int64)

        # ragged expansion: one row per (alignment, covered bin)
        counts = np.maximum(end_bin - start_bin, 0)
        total = int(counts.sum())
        if total == 0:
            return
        rep = np.repeat(np.arange(len(tid)), counts)
        # local bin index within [start_bin, end_bin)
        first = np.zeros(len(tid) + 1, dtype=np.int64)
        np.cumsum(counts, out=first[1:])
        local = np.arange(total, dtype=np.int64) - first[:-1][rep] + start_bin[rep]

        bw = self.rbw[tid][rep]
        tl = tlen[rep]
        # u32 truncation of the f64 products (`oarfish_types.rs:520-521`)
        cbs = (local.astype(np.float64) * bw).astype(np.int64)
        cbe = np.minimum((local + 1).astype(np.float64) * bw, tl).astype(np.int64)

        s_r = s[rep].astype(np.int64)
        e_r = e[rep].astype(np.int64)
        olap = np.where(
            s_r <= cbe,
            np.minimum(e_r, cbe) - np.maximum(s_r, cbs),
            0,
        )
        width = cbe - cbs
        frac = olap.astype(np.float64) / width.astype(np.float64)
        # bincount is ~10x np.add.at for large scatter-adds
        self.bins += np.bincount(
            self.bin_offsets[tid[rep]] + local, weights=frac,
            minlength=len(self.bins),
        )

    def normalized_counts_and_lengths(self):
        """Flat (counts f32, widths f32) per bin, matching
        `get_normalized_counts_and_lengths` (`oarfish_types.rs:471-493`)."""
        T = len(self.txp_len)
        local = np.arange(len(self.bins), dtype=np.int64) - np.repeat(
            self.bin_offsets[:-1], self.nbins
        )
        t_of_bin = np.repeat(np.arange(T, dtype=np.int64), self.nbins)
        bwf = _rust_round(self.lenf / self.nbins.astype(np.float64)).astype(
            np.float32
        )[t_of_bin]
        bidxf = local.astype(np.float32)
        bin_start = bidxf * bwf
        bin_end = np.minimum(
            (bidxf + np.float32(1.0)) * bwf, self.lenf.astype(np.float32)[t_of_bin]
        )
        return self.bins.astype(np.float32), (bin_end - bin_start)


class NameBlob:
    """Compact per-read name store: one contiguous bytes buffer +
    int64 offsets. The reference bounds RSS by spilling read names to
    an lz4-compressed disk-backed vec (`swapvec`, `bulk.rs:221-229`);
    here a blob costs ~28 B/read where a Python list of str costs
    ~100 B/read, which keeps even 100M-read runs in host RAM."""

    __slots__ = ("_buf", "_off")

    def __init__(self, buf=b"", off: Optional[np.ndarray] = None):
        # bytearray while appending; a uint8 ndarray (possibly a
        # read-only np.memmap — the disk-spill path) once built
        if isinstance(buf, np.ndarray):
            self._buf = buf
        else:
            self._buf = bytearray(buf)
        # int64 ndarray when built vectorized; plain list while appending
        if off is None:
            self._off = [0]
        elif isinstance(off, np.ndarray):
            self._off = off
        else:
            self._off = list(off)

    def append(self, name) -> None:
        if isinstance(name, str):
            name = name.encode()
        if isinstance(self._off, np.ndarray):
            self._off = self._off.tolist()
        if isinstance(self._buf, np.ndarray):
            self._buf = bytearray(self._buf.tobytes())
        self._buf += name
        self._off.append(len(self._buf))

    def __len__(self) -> int:
        return len(self._off) - 1

    def buffer_array(self) -> np.ndarray:
        """uint8 view of the name bytes (no copy for ndarray/memmap)."""
        if isinstance(self._buf, np.ndarray):
            return self._buf
        return np.frombuffer(bytes(self._buf), np.uint8)

    def offsets_array(self) -> np.ndarray:
        return np.asarray(self._off, dtype=np.int64)

    def __getitem__(self, i: int) -> str:
        return bytes(self._buf[self._off[i] : self._off[i + 1]]).decode()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, NameBlob):
            return (
                len(self) == len(other)
                and list(self._off) == list(other._off)
                and bytes(self._buf) == bytes(other._buf)
            )
        if isinstance(other, (list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    @staticmethod
    def from_nul_blob(blob: bytes, n: int) -> "NameBlob":
        """Wrap a NUL-separated name blob (the native decoder's output
        format) without materializing a Python list: offsets from the
        separator positions, names exclude the separators."""
        b = np.frombuffer(blob, np.uint8)
        seps = np.nonzero(b == 0)[0][:n]
        g_off = np.zeros(n + 1, np.int64)
        if len(seps) == n:
            g_off[1:] = seps + 1  # start of the NEXT name (past the NUL)
        else:
            # last name is not NUL-terminated
            assert len(seps) == n - 1, (len(seps), n)
            g_off[1:n] = seps + 1
            g_off[n] = len(blob)
        nb = NameBlob.__new__(NameBlob)
        nb._buf = bytearray(blob)
        nb._off = g_off  # note: entries include the trailing NULs
        # rebuild as exclusive-of-NUL blob: gather once
        return nb.take(np.arange(n))

    def take(self, idx: np.ndarray) -> "NameBlob":
        """Vectorized `NameBlob([self[i] for i in idx])`: gather the
        name bytes through a ramp index instead of a Python loop."""
        g_off = np.asarray(self._off, dtype=np.int64)
        buf = self.buffer_array()
        idx = np.asarray(idx, dtype=np.int64)
        starts = g_off[idx]
        lens = g_off[idx + 1] - starts
        # exclude a trailing NUL separator if present (from_nul_blob)
        has_nul = lens > 0
        last = np.where(has_nul, starts + lens - 1, 0)
        lens = lens - (has_nul & (buf[last] == 0))
        off = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        src = np.repeat(starts, lens) + (
            np.arange(int(off[-1])) - np.repeat(off[:-1], lens)
        )
        return NameBlob(buf[src].tobytes(), off)

    @staticmethod
    def concat(blobs) -> "NameBlob":
        """Concatenate NameBlobs (chunked streaming pack assembles the
        per-read name store from per-chunk pieces)."""
        blobs = [b for b in blobs if b is not None]
        if not blobs:
            return NameBlob()
        buf = b"".join(bytes(b._buf) for b in blobs)
        parts = [np.zeros(1, np.int64)]
        base = 0
        for b in blobs:
            o = np.asarray(b._off, dtype=np.int64)
            parts.append(o[1:] + base)
            base += int(o[-1])
        return NameBlob(buf, np.concatenate(parts))

    @staticmethod
    def from_indexed(names, idx: np.ndarray) -> "NameBlob":
        """Vectorized build of per-read names as `names[idx[r]]`. Accepts
        a NameBlob or any sequence of str/bytes."""
        if isinstance(names, NameBlob):
            return names.take(idx)
        enc = [
            n if isinstance(n, (bytes, bytearray)) else n.encode()
            for n in names
        ]
        blob = b"".join(enc)
        g_off = np.zeros(len(enc) + 1, np.int64)
        np.cumsum([len(e) for e in enc], out=g_off[1:])
        idx = np.asarray(idx, dtype=np.int64)
        lens = g_off[idx + 1] - g_off[idx]
        off = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        src = np.repeat(g_off[idx], lens) + (
            np.arange(int(off[-1])) - np.repeat(off[:-1], lens)
        )
        buf = np.frombuffer(blob, np.uint8)[src].tobytes()
        return NameBlob(buf, off)


class NameSpill:
    """Disk-backed assembly of the per-read name store. The reference
    bounds RSS under `--write-assignment-probs` by spilling read names
    to an lz4-compressed disk vec (swapvec, `bulk.rs:221-229`); here
    each chunk's kept-name blob is appended to an anonymous temp file
    and the final NameBlob wraps a read-only memmap — peak RSS for
    names becomes page-cache-managed instead of resident (int64
    offsets, 8 B/read, stay in RAM)."""

    def __init__(self, dir=None):
        import tempfile

        self._fh = tempfile.TemporaryFile(dir=dir)
        self._off_parts = [np.zeros(1, np.int64)]
        self._base = 0

    def add(self, blob: NameBlob) -> None:
        o = blob.offsets_array()
        n = int(o[-1])
        self._fh.write(bytes(blob._buf[:n]) if n else b"")
        self._off_parts.append(o[1:] + self._base)
        self._base += n

    def finish(self) -> NameBlob:
        self._fh.flush()
        off = np.concatenate(self._off_parts)
        if self._base == 0:
            self._fh.close()
            return NameBlob(b"", off)
        mm = np.memmap(self._fh, dtype=np.uint8, mode="r",
                       shape=(self._base,))
        return NameBlob(mm, off)


@dataclass
class AlignmentStore:
    """Flat CSR of read×alignment records (device-ready numpy arrays)."""

    txp_id: np.ndarray  # int32 [A]
    start: np.ndarray  # int64 [A] (1-based)
    end: np.ndarray  # int64 [A] (1-based inclusive)
    as_prob: np.ndarray  # float32 [A]
    cov_prob: np.ndarray  # float64 [A]
    boundaries: np.ndarray  # int64 [R+1]
    discard: DiscardTable
    num_unique_alignments: int = 0
    read_names: Optional[NameBlob] = None

    @property
    def num_reads(self) -> int:
        return len(self.boundaries) - 1

    @property
    def num_alignments(self) -> int:
        return len(self.txp_id)

    def read_ids(self) -> np.ndarray:
        """Segment id per alignment (the CSR row index expansion)."""
        lens = np.diff(self.boundaries)
        return np.repeat(np.arange(self.num_reads, dtype=np.int32), lens)

    def iter_groups(self):
        for r in range(self.num_reads):
            s, e = self.boundaries[r], self.boundaries[r + 1]
            yield slice(int(s), int(e))


class StoreBuilder:
    """Appends filtered groups and finalizes into an `AlignmentStore`."""

    def __init__(self, coverage: TranscriptCoverage, keep_names: bool = False):
        self.coverage = coverage
        self._txp: List[np.ndarray] = []
        self._start: List[np.ndarray] = []
        self._end: List[np.ndarray] = []
        self._prob: List[np.ndarray] = []
        self._sizes: List[int] = []
        self.discard = DiscardTable()
        self.num_unique_alignments = 0
        self.read_names: Optional[NameBlob] = (
            NameBlob() if keep_names else None
        )

    def add_filtered_batch(
        self,
        txp_id: np.ndarray,
        start: np.ndarray,
        end: np.ndarray,
        prob: np.ndarray,
        sizes: np.ndarray,
        names: Optional[List[str]] = None,
    ) -> None:
        """Append many already-filtered read groups at once (flat
        concatenated arrays + per-group sizes; every size > 0). One
        coverage pass instead of one per group — the vectorized
        genome-mode filter path (round 5). Equivalent to
        `add_filtered_group` called per group (coverage bins differ
        only in FP accumulation order)."""
        if len(sizes) == 0:
            return
        self.coverage.add_intervals(txp_id, start, end)
        self._txp.append(np.asarray(txp_id, dtype=np.int32))
        self._start.append(np.asarray(start, dtype=np.int64))
        self._end.append(np.asarray(end, dtype=np.int64))
        self._prob.append(np.asarray(prob, dtype=np.float32))
        self._sizes.extend(int(x) for x in sizes)
        if self.read_names is not None:
            if names is None:
                names = [""] * len(sizes)
            for nm in names:
                self.read_names.append(nm)

    def add_filtered_group(
        self, g: FilteredGroup, name: Optional[str] = None
    ) -> bool:
        """Equivalent of `add_filtered_group` (`oarfish_types.rs:718-738`):
        records the group, updates coverage bins, pushes a boundary."""
        if g is None or len(g.txp_id) == 0:
            return False
        self.coverage.add_intervals(g.txp_id, g.start, g.end)
        self._txp.append(g.txp_id)
        self._start.append(g.start)
        self._end.append(g.end)
        self._prob.append(g.prob)
        self._sizes.append(len(g.txp_id))
        if self.read_names is not None:
            self.read_names.append(name if name is not None else "")
        return True

    def finalize(self) -> AlignmentStore:
        txp = (
            np.concatenate(self._txp)
            if self._txp
            else np.empty(0, np.int32)
        )
        boundaries = np.zeros(len(self._sizes) + 1, dtype=np.int64)
        np.cumsum(self._sizes, out=boundaries[1:])
        return AlignmentStore(
            txp_id=txp.astype(np.int32),
            start=(
                np.concatenate(self._start) if self._start else np.empty(0, np.int64)
            ),
            end=np.concatenate(self._end) if self._end else np.empty(0, np.int64),
            as_prob=(
                np.concatenate(self._prob)
                if self._prob
                else np.empty(0, np.float32)
            ),
            cov_prob=np.zeros(len(txp), dtype=np.float64),
            boundaries=boundaries,
            discard=self.discard,
            num_unique_alignments=self.num_unique_alignments,
            read_names=self.read_names,
        )
