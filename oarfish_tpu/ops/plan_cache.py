"""Persistent v4 routing-plan cache.

The v4 layout + route tables are a pure function of the CSR STRUCTURE
(`txp_id`, `boundaries`, `num_txps`) plus a handful of layout env knobs
— per-alignment weights only enter at the final `w_txp` fill. Building
them costs tens of seconds at GENCODE scale (the dominant host phase of
a warm run; VERDICT r2 weak-1), so re-quantifying the same alignments
(different filters downstream of packing don't change the CSR? they do
— the key hashes the POST-filter CSR, so any change that alters the
retained alignments changes the key) with different EM options,
bootstrap counts, or output surfaces should not pay it twice.

This is the same design point as JAX's persistent compilation cache
(already enabled by the CLI): key = blake2b over the structure bytes +
knob fingerprint + format version; value = the host-side layout products
and the nine int8 routing tables per route, pickled. On a hit the build
reduces to one `w_txp` scatter + device transfers.

Cache location: `$OARFISH_PLAN_CACHE_DIR` or
`~/.cache/oarfish_tpu/plans`; disable with `OARFISH_PLAN_CACHE=0`. Total
size is capped (`OARFISH_PLAN_CACHE_GB`, default 4) with oldest-first
eviction.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("oarfish_tpu")

VERSION = 3

# env knobs that change the layout/route construction — part of the key
_KNOBS = (
    "OARFISH_CANONICAL",
    "OARFISH_CANONICAL_MIN",
    "OARFISH_CANON_HEADROOM",
    "OARFISH_CANON_LADDER",
    "OARFISH_RECT",
    "OARFISH_NO_REPAIR",
    "OARFISH_ROUTE_Q128",
    "OARFISH_V4_NO_BALANCE",
    "OARFISH_FORCE_CR",
)

# lay fields the cached finish needs (everything except the A-sized
# slot_of_aln — only the route build consumes it — and weights/dbg)
_LAY_FIELDS = (
    "txp_slot_of_aln", "read_order", "big_row_of_txp", "big_row_offsets",
    "read_shapes", "read_starts", "n_slots_r", "row_space_r",
    "small_shapes", "small_starts", "row_space_s", "big_rows_pad",
    "n_big", "n_slots_t", "t_space", "num_reads", "num_txps",
)


def enabled() -> bool:
    return os.environ.get("OARFISH_PLAN_CACHE", "1") != "0"


def cache_dir() -> Path:
    d = os.environ.get("OARFISH_PLAN_CACHE_DIR")
    if d:
        return Path(d)
    return Path.home() / ".cache" / "oarfish_tpu" / "plans"


def layout_key(txp_id: np.ndarray, boundaries: np.ndarray,
               num_txps: int) -> str:
    h = hashlib.blake2b(digest_size=20)
    h.update(f"v{VERSION};T={num_txps};".encode())
    for k in _KNOBS:
        h.update(f"{k}={os.environ.get(k, '')};".encode())
    t = np.ascontiguousarray(txp_id)
    b = np.ascontiguousarray(boundaries)
    h.update(str(t.dtype).encode())
    h.update(t.tobytes())
    h.update(str(b.dtype).encode())
    h.update(b.tobytes())
    return h.hexdigest()


def load(key: str) -> Optional[dict]:
    p = cache_dir() / f"{key}.plan"
    try:
        with open(p, "rb") as fh:
            payload = pickle.load(fh)
        if payload.get("version") != VERSION:
            return None
        os.utime(p)  # LRU touch
        return payload
    except FileNotFoundError:
        return None
    except Exception as e:  # noqa: BLE001 — a corrupt entry is a miss
        log.warning("plan cache entry %s unreadable (%s); rebuilding",
                    p.name, e)
        try:
            p.unlink()
        except OSError:
            pass
        return None


def _evict(budget_bytes: int, incoming: int) -> None:
    d = cache_dir()
    try:
        entries = sorted(
            ((p.stat().st_mtime, p.stat().st_size, p)
             for p in d.glob("*.plan")),
        )
    except OSError:
        return
    total = sum(s for _, s, _ in entries) + incoming
    for _, size, p in entries:
        if total <= budget_bytes:
            break
        try:
            p.unlink()
            total -= size
        except OSError:
            pass


def store_async(key: str, payload: dict,
                pointer_key: Optional[str] = None) -> threading.Thread:
    """Serialize + write on a background thread (the payload is already
    host-resident; pickling ~hundreds of MB costs ~1s we keep off the
    run's critical path). The BAM pointer, when given, is written ONLY
    after the entry is durably renamed — a pointer to a not-yet-written
    entry would make the next run's prefetch miss silently."""

    def write():
        try:
            d = cache_dir()
            d.mkdir(parents=True, exist_ok=True)
            payload["version"] = VERSION
            blob = pickle.dumps(payload, protocol=5)
            budget = int(
                float(os.environ.get("OARFISH_PLAN_CACHE_GB", "4")) * 1e9
            )
            _evict(budget, len(blob))
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, d / f"{key}.plan")
            if pointer_key is not None:
                write_pointer(pointer_key, key)
        except Exception as e:  # noqa: BLE001 — cache is best-effort
            log.warning("plan cache store failed: %s", e)

    th = threading.Thread(target=write, daemon=True)
    th.start()
    return th


def payload_from_build(lay: dict, routes_host: Tuple[dict, dict],
                       seg_id: Optional[np.ndarray]) -> dict:
    return {
        "lay": {k: lay[k] for k in _LAY_FIELDS},
        "routes": routes_host,
        "seg_id": seg_id,
        # host tile-permute specs (~2 MB); t_in/t_out are rebuilt from
        # these on load so the store thread never touches the device (a
        # device_get here would queue behind the cold run's EM compile)
        "t_perms": (lay["t_perm_in"], lay["t_perm_out"], lay["t_rows"]),
    }


def _device_parts(payload: dict) -> dict:
    """Ship the weight-independent cached products to device (the bulk
    of a cache hit's wall — route tables + permutes)."""
    import jax.numpy as jnp

    from .static_permute import (
        BatchTilePermute,
        DeviceTilePlan,
        GlobalRoutePlan,
    )

    from .static_permute import batched_device_tables

    lay = payload["lay"]
    # ONE host->device transfer for both routes' 18 tables (see
    # batched_device_tables)
    devs = batched_device_tables(
        [payload["routes"][0]["tables"], payload["routes"][1]["tables"]]
    )

    def plan(h, t):
        (n_in, n_out, n_src, n_dst, Q, R1, R3, CR) = h["meta"]
        return GlobalRoutePlan(
            s1_r1=t[0],
            s1_src=t[1],
            s1_row=t[2],
            s1_r2=t[3],
            s3_r1=t[4],
            s3_src=t[5],
            s3_row=t[6],
            s3_r2=t[7],
            s3_mask=t[8],
            n_in=n_in, n_out=n_out, n_src=n_src, n_dst=n_dst,
            Q=Q, R1=R1, R3=R3, chunk_rows=CR,
        )

    seg_id = payload["seg_id"]
    perm_in, perm_out, t_rows = payload["t_perms"]
    t_in = BatchTilePermute.build([DeviceTilePlan.build(perm_in, t_rows)])
    t_out = BatchTilePermute.build([DeviceTilePlan.build(perm_out, t_rows)])
    return {
        "p_a": plan(payload["routes"][0], devs[0]),
        "p_b": plan(payload["routes"][1], devs[1]),
        "t_io": (t_in, t_out),
        "seg_id": None if seg_id is None else jnp.asarray(seg_id),
        "big_row_of_txp": jnp.asarray(lay["big_row_of_txp"],
                                      dtype=jnp.int32),
        "big_row_offsets": jnp.asarray(lay["big_row_offsets"],
                                       dtype=jnp.int32),
    }


def _assemble(payload: dict, parts: dict, weights: np.ndarray):
    import jax.numpy as jnp

    from .em_v4 import EmV4Data
    from .static_permute import LANES

    lay = payload["lay"]
    n_src = payload["routes"][0]["meta"][2]
    CR = payload["routes"][0]["meta"][7]
    w_txp = np.zeros(n_src * CR * LANES, dtype=np.float64)
    w_txp[lay["txp_slot_of_aln"]] = weights
    t_in, t_out = parts["t_io"]
    data = EmV4Data(
        w_txp=jnp.asarray(w_txp, dtype=jnp.float32),
        p_a=parts["p_a"],
        p_b=parts["p_b"],
        t_in=t_in,
        t_out=t_out,
        big_row_of_txp=parts["big_row_of_txp"],
        big_row_offsets=parts["big_row_offsets"],
        seg_id=parts["seg_id"],
        read_shapes=lay["read_shapes"],
        read_starts=lay["read_starts"],
        n_slots_r=lay["n_slots_r"],
        row_space_r=lay["row_space_r"],
        small_shapes=lay["small_shapes"],
        small_starts=lay["small_starts"],
        row_space_s=lay["row_space_s"],
        big_rows_pad=lay["big_rows_pad"],
        n_big=lay["n_big"],
        n_slots_t=lay["n_slots_t"],
        t_space=lay["t_space"],
        num_reads=lay["num_reads"],
        num_txps=lay["num_txps"],
    )
    return data, lay["read_order"]


def finish_from_cache(payload: dict, weights: np.ndarray):
    """Reassemble (EmV4Data, read_order) from a cache hit + this run's
    weights. Mirrors `_v4_finish` minus the route build."""
    return _assemble(payload, _device_parts(payload), weights)


# ---------------------------------------------------------------------------
# Speculative prefetch: overlap a probable hit's device transfers with
# the streaming pack. The pointer key is the BAM's file identity
# (realpath/size/mtime) + the CSR-affecting filter fingerprint — a HINT
# only; the authoritative check is the structural key computed from the
# packed CSR before use.
# ---------------------------------------------------------------------------


def bam_pointer_key(path, fingerprint: str) -> Optional[str]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    h = hashlib.blake2b(digest_size=20)
    h.update(
        f"ptr{VERSION};{os.path.realpath(path)};{st.st_size};"
        f"{st.st_mtime_ns};{fingerprint}".encode()
    )
    return h.hexdigest()


def read_pointer(ptr_key: str) -> Optional[str]:
    try:
        return (cache_dir() / f"{ptr_key}.ptr").read_text().strip()
    except OSError:
        return None


def write_pointer(ptr_key: str, structural_key: str) -> None:
    try:
        d = cache_dir()
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{ptr_key}.ptr").write_text(structural_key)
    except OSError as e:
        log.warning("plan cache pointer write failed: %s", e)


class Prefetch:
    """Reconstructs a cached plan's device state on a worker thread
    while the pack streams. `finish` joins, verifies the structural key
    computed from the actual packed CSR, and returns (EmV4Data,
    read_order) — or None on any mismatch/failure (the caller falls
    back to the synchronous hit path / a full build)."""

    def __init__(self, structural_key: str):
        import threading as _threading

        self.key = structural_key
        self._res: dict = {}
        self._th = _threading.Thread(target=self._build, daemon=True)
        self._th.start()

    def _build(self):
        # the entry unpickle (hundreds of MB) happens HERE, off the
        # caller's critical path — a synchronous load() before the pack
        # cost ~10s of the warm run's parse phase at the 5M scale
        try:
            payload = load(self.key)
            if payload is None:
                raise FileNotFoundError(
                    f"plan entry {self.key[:12]}… vanished before prefetch"
                )
            self._res["payload"] = payload
            self._res["parts"] = _device_parts(payload)
        except BaseException as e:  # noqa: BLE001 — fall back at finish
            self._res["err"] = e

    def status(self) -> str:
        """Non-blocking: 'pending' while the worker loads, 'ok' once the
        payload is unpickled + version-checked and device parts staged,
        'failed' on any load error. Lets the caller keep a hedge (the
        V4Prebuild) alive exactly until the entry is known-loadable."""
        if self._th.is_alive():
            return "pending"
        return "failed" if "err" in self._res else "ok"

    def finish(self, structural_key: str, weights: np.ndarray):
        self._th.join()
        if structural_key != self.key or "err" in self._res:
            if "err" in self._res:
                log.warning("plan prefetch failed: %s", self._res["err"])
            else:
                log.info(
                    "plan prefetch pointer was stale (CSR changed); "
                    "ignoring"
                )
            return None
        return _assemble(
            self._res["payload"], self._res["parts"], weights
        )


def prefetch_for_bam(path, fingerprint: str) -> Optional[Prefetch]:
    """Start a speculative plan prefetch for this BAM + filter config;
    None when there is no pointer/entry."""
    if not enabled():
        return None
    ptr = bam_pointer_key(path, fingerprint)
    if ptr is None:
        return None
    skey = read_pointer(ptr)
    if skey is None:
        return None
    if not (cache_dir() / f"{skey}.plan").exists():  # cheap existence probe
        return None
    log.info("plan cache: prefetching %s… during the pack", skey[:12])
    return Prefetch(skey)


# ---- sticky shape-class envelopes (cross-dataset compile reuse) ----
#
# Quantization alone cannot make two datasets' shapes collide (any
# lattice has boundaries, and ~25 independent values must ALL match).
# Instead the first dataset of a scale class defines the class envelope
# (its natural shapes, 1/8-mantissa-quantized up) and later datasets
# REUSE it verbatim when they fit underneath — the common
# same-pipeline-new-flowcell case — growing it monotonically otherwise.
# Class key: floor(2*log2(A)) — datasets within sqrt(2) of each other
# share a class, which also bounds the dead-slot waste of reusing a
# bigger envelope.

ENV_VERSION = 2  # v2: records carry the envelope knobs (headroom/ladder)


def env_class_key(num_aln: int) -> str:
    import math

    return f"c{int(2 * math.log2(max(num_aln, 2)))}"


def _env_path(key: str) -> Path:
    return cache_dir() / f"env_{key}.json"


def load_env_class(key: str) -> Optional[dict]:
    import json

    try:
        with open(_env_path(key)) as fh:
            rec = json.load(fh)
        if rec.get("version") != ENV_VERSION:
            return None
        if rec.get("knobs") != _env_knobs():
            # built under different envelope quantization knobs; a fat
            # (old-headroom) record would "fit" every later dataset and
            # silently keep its per-iteration padding tax
            return None
        env = rec["env"]
        env["read_buckets"] = tuple(map(tuple, env["read_buckets"]))
        env["small_buckets"] = tuple(map(tuple, env["small_buckets"]))
        return rec
    except FileNotFoundError:
        return None
    except Exception as e:  # noqa: BLE001
        log.warning("envelope class %s unreadable (%s)", key, e)
        return None


def _env_knobs() -> list:
    return [os.environ.get("OARFISH_CANON_HEADROOM", "1.0"),
            os.environ.get("OARFISH_CANON_LADDER", "1")]


def store_env_class(key: str, env: dict, geometry) -> None:
    import json

    rec = {
        "version": ENV_VERSION,
        "knobs": _env_knobs(),
        "env": {
            **env,
            "read_buckets": [list(b) for b in env["read_buckets"]],
            "small_buckets": [list(b) for b in env["small_buckets"]],
        },
        "geometry": list(geometry) if geometry else None,
    }
    try:
        d = cache_dir()
        d.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as fh:
            json.dump(rec, fh)
        os.replace(tmp, _env_path(key))
    except OSError as e:
        log.warning("envelope class store failed: %s", e)


def env_slots(e: dict) -> int:
    return (
        sum(rp * K for K, rp in e["read_buckets"])
        + sum(rp * K for K, rp in e["small_buckets"])
        + e["big_rows_pad"] * 2048
    )


def env_fits(nat: dict, stored: dict, ref: Optional[dict] = None,
             max_waste: float = 1.35) -> bool:
    """True when `nat` (a natural envelope) fits under `stored` with
    bounded slot waste — every bucket present with enough rows, big and
    tile spaces large enough. Waste is judged against `ref` (what this
    dataset would build for itself anyway — its own canonical
    envelope), not the bare natural shapes."""

    def buckets_fit(n, s):
        sd = dict(s)
        return all(K in sd and sd[K] >= rp for K, rp in n)

    if not buckets_fit(nat["read_buckets"], stored["read_buckets"]):
        return False
    if not buckets_fit(nat["small_buckets"], stored["small_buckets"]):
        return False
    if (
        stored["big_rows_pad"] < nat["big_rows_pad"]
        or stored["n_big"] < nat["n_big"]
        or stored["t_rows"] < nat["t_rows"]
    ):
        return False
    base = env_slots(ref if ref is not None else nat)
    return env_slots(stored) <= max_waste * max(base, 1)


def env_class_neighbors(key: str):
    """The class itself first, then its two sqrt(2) neighbors."""
    n = int(key[1:])
    return (key, f"c{n - 1}", f"c{n + 1}")
