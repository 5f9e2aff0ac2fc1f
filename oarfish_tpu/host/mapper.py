"""ctypes bindings for the C++ minimizer mapper (csrc/mapper.cpp) plus
index persistence with the OARFISHSIG digest footer.

Equivalent of the reference's rammap wrapper
(`src/util/mapper.rs`) and aligner/index construction
(`src/util/aligner.rs`): presets per sequencing tech
(`aligner.rs:34-41`), FASTA build, `--index-out` persist with the digest
footer (`aligner.rs:133-216`), prebuilt-index load (`aligner.rs:78-131`).
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import SequencingTech
from ..utils.digest import append_digest_footer, read_digest_footer

log = logging.getLogger("oarfish_tpu")

_CSRC = Path(__file__).resolve().parent.parent.parent / "csrc"
_LIB_PATH = _CSRC / "liboarfish_mapper.so"
_lib = None
_lib_tried = False


class _MapResult(ctypes.Structure):
    _fields_ = [
        ("n_hits", ctypes.c_int64),
        ("read_off", ctypes.POINTER(ctypes.c_int64)),
        ("target", ctypes.POINTER(ctypes.c_int32)),
        ("tstart", ctypes.POINTER(ctypes.c_int64)),
        ("tend", ctypes.POINTER(ctypes.c_int64)),
        ("qstart", ctypes.POINTER(ctypes.c_int64)),
        ("qend", ctypes.POINTER(ctypes.c_int64)),
        ("score", ctypes.POINTER(ctypes.c_int32)),
        ("is_rc", ctypes.POINTER(ctypes.c_uint8)),
        ("n_blocks", ctypes.c_int64),
        ("block_off", ctypes.POINTER(ctypes.c_int64)),
        ("block_s", ctypes.POINTER(ctypes.c_int64)),
        ("block_e", ctypes.POINTER(ctypes.c_int64)),
    ]


def get_lib():
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    src = _CSRC / "mapper.cpp"
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                 "-fPIC", str(src), "-o", str(_LIB_PATH), "-pthread"],
                check=True, capture_output=True, timeout=300,
            )
        except Exception as e:  # noqa: BLE001
            log.warning("could not build native mapper: %s", e)
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:
        log.warning("could not load native mapper: %s", e)
        return None
    lib.oarfish_index_build.restype = ctypes.c_void_p
    lib.oarfish_index_build.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double,
    ]
    lib.oarfish_index_free.argtypes = [ctypes.c_void_p]
    lib.oarfish_index_num_targets.restype = ctypes.c_int64
    lib.oarfish_index_num_targets.argtypes = [ctypes.c_void_p]
    lib.oarfish_map_batch.restype = ctypes.POINTER(_MapResult)
    lib.oarfish_map_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.oarfish_map_result_free.argtypes = [ctypes.POINTER(_MapResult)]
    lib.oarfish_index_save.restype = ctypes.c_int
    lib.oarfish_index_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.oarfish_index_load.restype = ctypes.c_void_p
    lib.oarfish_index_load.argtypes = [ctypes.c_char_p]
    lib.oarfish_index_names_len.restype = ctypes.c_int64
    lib.oarfish_index_names_len.argtypes = [ctypes.c_void_p]
    lib.oarfish_index_get_meta.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.oarfish_index_seqs_len.restype = ctypes.c_int64
    lib.oarfish_index_seqs_len.argtypes = [ctypes.c_void_p]
    lib.oarfish_index_get_seqs.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
    ]
    if hasattr(lib, "oarfish_index_get_seqs_upper"):
        lib.oarfish_index_get_seqs_upper.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
    lib.oarfish_index_set_junctions.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    if hasattr(lib, "oarfish_index_peek_names"):
        lib.oarfish_index_peek_names.restype = ctypes.c_void_p
        lib.oarfish_index_peek_names.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.oarfish_free_blob.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def peek_index_names(path) -> Optional[List[str]]:
    """Read ONLY the target-name table from an OTMI header (ms vs the
    full load) — lets the genome driver build its g2t index under the
    index load. None when unavailable (foreign/corrupt index or old
    .so)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "oarfish_index_peek_names"):
        return None
    n = ctypes.c_int64(0)
    blen = ctypes.c_int64(0)
    p = lib.oarfish_index_peek_names(
        str(path).encode(), ctypes.byref(n), ctypes.byref(blen)
    )
    if not p:
        return None
    try:
        raw = ctypes.string_at(p, blen.value)
    finally:
        lib.oarfish_free_blob(p)
    names = raw.decode(errors="replace").split("\x00")[: n.value]
    return names


def available() -> bool:
    return get_lib() is not None


def set_dp_cache_cap_mb(mb: Optional[int]) -> bool:
    """Cap the mapper's per-worker-thread scratch memory retained across
    reads (`--dp-cache-cap-mb`; reference knob `RAMMAP_DP_CACHE_CAP_MB`,
    `Cargo.toml:84-87`, `main.rs:347-349`, default 128 MB/thread). None
    or <=0 restores the default. Returns False when the loaded native
    library predates the knob (stale .so)."""
    if mb is None:
        # flag absent: honor the reference's env knob before the default
        import os

        env = os.environ.get("RAMMAP_DP_CACHE_CAP_MB")
        if env is not None:
            try:
                mb = int(env)
            except ValueError:
                log.warning("ignoring non-integer RAMMAP_DP_CACHE_CAP_MB=%r", env)
    lib = get_lib()
    if lib is None or not hasattr(lib, "oarfish_set_dp_cache_cap_mb"):
        return False
    lib.oarfish_set_dp_cache_cap_mb.argtypes = [ctypes.c_int64]
    lib.oarfish_set_dp_cache_cap_mb(int(mb) if mb else 0)
    return True


def preset_for_tech(tech: Optional[SequencingTech]) -> Tuple[int, int]:
    """(k, w) minimizer preset per sequencing tech (the analogue of
    rammap's map-ont / map-pb / map-hifi presets, `aligner.rs:34-41`)."""
    if tech in (SequencingTech.ONT_CDNA, SequencingTech.ONT_DRNA, None):
        return 15, 10
    if tech == SequencingTech.PACBIO:
        return 19, 10
    return 19, 19  # PacBioHifi


class MapHits:
    """Columnar mapping results for a read batch."""

    def __init__(self, read_off, target, tstart, tend, qstart, qend, score,
                 is_rc, block_off=None, block_s=None, block_e=None):
        self.read_off = read_off
        self.target = target
        self.tstart = tstart
        self.tend = tend
        self.qstart = qstart
        self.qend = qend
        self.score = score
        self.is_rc = is_rc
        self.block_off = block_off
        self.block_s = block_s
        self.block_e = block_e


class Mapper:
    def __init__(self, handle, names: List[str], lengths: List[int],
                 k: int, w: int, threads: int = 4):
        self._h = handle
        self.names = names
        self.lengths = lengths
        self.k = k
        self.w = w
        self.threads = threads  # used by native helpers (seqs accessor)

    @classmethod
    def from_sequences(
        cls,
        names: Sequence[str],
        seqs: Sequence[bytes],
        tech: Optional[SequencingTech] = None,
        threads: int = 4,
        freq_cutoff_frac: float = 2e-4,
        kw: Optional[Tuple[int, int]] = None,
    ) -> "Mapper":
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native mapper unavailable")
        k, w = kw if kw is not None else preset_for_tech(tech)
        blob = b"".join(seqs)
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=offsets[1:])
        names_blob = b"".join(n.encode() + b"\x00" for n in names)
        h = lib.oarfish_index_build(
            blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(seqs),
            names_blob,
            k,
            w,
            threads,
            freq_cutoff_frac,
        )
        return cls(h, list(names), [len(s) for s in seqs], k, w,
                   threads=threads)

    @classmethod
    def load(cls, path, threads: int = 4) -> "Mapper":
        """Load a prebuilt index. OTMI loads directly; a legacy
        minimap2 `.mmi` that embeds sequences is migrated — the
        container is parsed and an OTMI is rebuilt in-process using the
        .mmi's own k/w (the reference likewise reuses foreign indexes
        and honors the index's own parameters, `aligner.rs:78-98`).
        Sequence-stripped .mmi and rammap RMMI are rejected with a
        precise format description and a rebuild command."""
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native mapper unavailable")
        foreign = cls._classify_foreign_index(path)
        if foreign is not None:
            return cls._migrate_foreign(path, foreign, threads)
        h = lib.oarfish_index_load(str(path).encode())
        if not h:
            raise ValueError(f"could not load index {path}")
        n = lib.oarfish_index_num_targets(h)
        nlen = lib.oarfish_index_names_len(h)
        names_buf = ctypes.create_string_buffer(int(nlen))
        lengths = np.zeros(n, dtype=np.int64)
        kw = (ctypes.c_int32 * 2)()
        lib.oarfish_index_get_meta(
            h, names_buf,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), kw,
        )
        names = names_buf.raw.decode(errors="replace").split("\x00")[: int(n)]
        return cls(h, names, [int(x) for x in lengths], int(kw[0]),
                   int(kw[1]), threads=threads)

    #: set on instances migrated from a foreign container: ("mmi",
    #: decoded sequences as list[bytes]) — the driver uses the
    #: sequences for the full reference digest (the reference likewise
    #: recomputes the signature from index-embedded sequences when the
    #: oarfish footer is absent, `aligner.rs:106-117`) and may persist
    #: the converted OTMI via --index-out.
    migrated_from: Optional[str] = None
    migrated_seqs: Optional[list] = None

    _REBUILD_MSG = (
        "rebuild from the reference FASTA once with `oarfish-tpu "
        "--annotated ref.fa --only-index --index-out IDX` and pass "
        "that via --index."
    )

    @staticmethod
    def _classify_foreign_index(path) -> Optional[str]:
        """Identify the index container by magic: None for our own
        OTMI, 'mmi' for legacy minimap2, or raise for formats we can
        neither load nor migrate. The reference loads rammap RMMI and
        legacy `.mmi` directly (`aligner.rs:72-98`); we migrate `.mmi`
        (host/mmi.py) and reject RMMI (format unobtainable offline)."""
        try:
            with open(path, "rb") as fh:
                head = fh.read(8)
        except OSError as e:
            raise ValueError(f"could not open index {path}: {e}") from None
        if head[:5] == b"OTMI\x01":
            return None
        if head[:4] == b"MMI\x02":
            return "mmi"
        if head[:4] in (b"RMI\x01", b"RMMI"):
            kind = "a rammap RMMI index"
        else:
            kind = "not an oarfish-tpu OTMI index"
        raise ValueError(
            f"{path}: this file is {kind}. oarfish-tpu reads its own "
            f"OTMI format and migrates legacy minimap2 .mmi indexes "
            f"that embed sequences; {Mapper._REBUILD_MSG}"
        )

    @classmethod
    def _migrate_foreign(cls, path, kind: str, threads: int) -> "Mapper":
        assert kind == "mmi"
        from .mmi import parse_mmi

        idx = parse_mmi(path)
        if not idx.has_sequences:
            raise ValueError(
                f"{path}: this is a {idx.describe()}. It was built with "
                f"--idx-no-seq, so the reference sequences cannot be "
                f"recovered from it; {cls._REBUILD_MSG}"
            )
        log.warning(
            "%s is a %s; migrating: rebuilding a native OTMI index from "
            "the embedded sequences with the index's own k/w "
            "(indexing-related --seq-tech parameters are ignored). "
            "Pass --index-out to persist the converted index.",
            path, idx.describe(),
        )
        m = cls.from_sequences(
            idx.names, idx.seqs, threads=threads, kw=(idx.k, idx.w)
        )
        m.migrated_from = kind
        m.migrated_seqs = idx.seqs
        return m

    def sequences_blob(self):
        """Embedded target sequences as ONE concatenated uint8 array +
        int64 offsets [n+1] — no per-target split, no zero-fill, no
        bytes round trip (each costs a pass over a ~1 GB genome; the
        native projection engine consumes the array's pointer
        directly). The array is UPPERCASED in place."""
        lib = get_lib()
        total = int(lib.oarfish_index_seqs_len(self._h))
        n = len(self.names)
        arr = np.empty(max(total, 1), dtype=np.uint8)
        offs = np.zeros(n + 1, dtype=np.int64)
        if hasattr(lib, "oarfish_index_get_seqs_upper"):
            # fused copy+uppercase, multithreaded in the native layer
            lib.oarfish_index_get_seqs_upper(
                self._h, arr.ctypes.data_as(ctypes.c_char_p),
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_int(self.threads),
            )
            return arr[:total], offs
        lib.oarfish_index_get_seqs(
            self._h, arr.ctypes.data_as(ctypes.c_char_p),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )
        arr = arr[:total]
        # single-pass uppercase: uint8 wraparound makes (c-97)<=25 the
        # lowercase test; where= avoids the fancy-index slow path
        lower = (arr - np.uint8(97)) <= 25
        np.subtract(arr, 32, out=arr, where=lower)
        return arr, offs

    def sequences(self) -> list:
        """Copy the index's embedded target sequences out as
        list[bytes] (the index keeps them for alignment rescoring).
        Used when --genome is given a prebuilt index: the soft-clip
        RescueDb and the reference digest are built from the index's
        own sequences, mirroring the reference's index-embedded-
        signature path (`aligner.rs:106-117`)."""
        lib = get_lib()
        total = int(lib.oarfish_index_seqs_len(self._h))
        n = len(self.names)
        buf = ctypes.create_string_buffer(max(total, 1))
        offs = np.zeros(n + 1, dtype=np.int64)
        lib.oarfish_index_get_seqs(
            self._h, buf, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )
        raw = buf.raw[:total]
        return [raw[offs[i]:offs[i + 1]] for i in range(n)]

    def save(self, path, digest_map: Optional[dict] = None) -> None:
        lib = get_lib()
        rc = lib.oarfish_index_save(self._h, str(path).encode())
        if rc != 0:
            raise IOError(f"could not write index to {path}")
        if digest_map is not None:
            append_digest_footer(str(path), digest_map)

    def set_junctions(self, juncs_by_name, tol: Optional[int] = None):
        """Load annotated splice junctions as spliced-chaining hints
        (`main.rs:255-281` feeds the junction BED into the reference's
        spliced aligner). `juncs_by_name`: dict target name -> iterable
        of (donor, acceptor) 0-based intron intervals. Junctions for
        unknown targets are ignored. Returns the number loaded."""
        import numpy as np

        lib = get_lib()
        name_to_id = {n: i for i, n in enumerate(self.names)}
        per_target = [[] for _ in self.names]
        n_loaded = 0
        for name, pairs in juncs_by_name.items():
            tid = name_to_id.get(name)
            if tid is None:
                continue
            for d, a in pairs:
                per_target[tid].append((int(d), int(a)))
                n_loaded += 1
        off = np.zeros(len(self.names) + 1, dtype=np.int64)
        donors = []
        accs = []
        for i, pairs in enumerate(per_target):
            pairs = sorted(set(pairs))
            donors.extend(p[0] for p in pairs)
            accs.extend(p[1] for p in pairs)
            off[i + 1] = len(donors)
        donor_arr = np.asarray(donors, dtype=np.int32)
        acc_arr = np.asarray(accs, dtype=np.int32)
        if tol is None:
            tol = self.k + self.w
        lib.oarfish_index_set_junctions(
            self._h,
            off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            donor_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            acc_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(tol),
        )
        return n_loaded

    def map_batch(self, seqs: Sequence[bytes], best_n: int = 100,
                  threads: int = 4, spliced: bool = False,
                  rescore: bool = True) -> MapHits:
        """Map a read batch. `rescore` (unspliced mode) replaces the
        chain-count score approximation with base-level alignment scores
        (banded affine DP between anchors + x-drop end extension), the
        analogue of rammap's extension-DP AS values."""
        lib = get_lib()
        blob = b"".join(seqs)
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=offsets[1:])
        rptr = lib.oarfish_map_batch(
            self._h,
            blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(seqs),
            int(best_n),
            int(threads),
            1 if spliced else 0,
            1 if rescore else 0,
        )
        r = rptr.contents
        n = int(r.n_hits)

        def arr(p, count, dt):
            if count == 0 or not p:
                return np.empty(0, dtype=dt)
            return np.ctypeslib.as_array(p, shape=(count,)).copy()

        out = MapHits(
            read_off=arr(r.read_off, len(seqs) + 1, np.int64),
            target=arr(r.target, n, np.int32),
            tstart=arr(r.tstart, n, np.int64),
            tend=arr(r.tend, n, np.int64),
            qstart=arr(r.qstart, n, np.int64),
            qend=arr(r.qend, n, np.int64),
            score=arr(r.score, n, np.int32),
            is_rc=arr(r.is_rc, n, np.uint8).astype(bool),
        )
        if spliced:
            nb = int(r.n_blocks)
            out.block_off = arr(r.block_off, n + 1, np.int64)
            out.block_s = arr(r.block_s, nb, np.int64)
            out.block_e = arr(r.block_e, nb, np.int64)
        lib.oarfish_map_result_free(rptr)
        return out

    def __del__(self):
        lib = _lib
        if lib is not None and getattr(self, "_h", None):
            lib.oarfish_index_free(self._h)
            self._h = None


def index_digest_footer(path) -> dict:
    """Read back the OARFISHSIG footer of a saved index."""
    return read_digest_footer(str(path))
