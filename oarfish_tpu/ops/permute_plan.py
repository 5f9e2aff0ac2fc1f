"""Static-permutation routing plans for `[R, 128]` tiles.

Any FIXED permutation of a `[R, 128]` tile decomposes (Slepian–Duguid three-stage network) into

    R1: an independent lane-permutation within each row,
    C:  an independent row-permutation within each column,
    R2: another per-row lane-permutation,

where R1/R2 are 128-lane shuffles (`take_along_axis` axis 1) and C is
realized by transposing 128x128 blocks and shuffling again.
The decomposition reduces to edge-coloring a C-regular bipartite
multigraph (source row -> dest row, one edge per element) with C = 128
colors, done by recursive Euler splitting (C is a power of two, so every
split is even).

Everything here is host-side numpy producing static index arrays; the
device code that consumes them lives in `static_permute.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

LANES = 128


def _euler_split(src: np.ndarray, dst: np.ndarray, degree: int):
    """Split a `degree`-regular bipartite multigraph into two halves of
    degree/2 by orienting Euler circuits. Returns a boolean array: edge in
    half 1. Nodes: src values (left), dst values (right)."""
    E = len(src)
    # adjacency: for each node, list of (edge_id, other_endpoint, is_left)
    # bipartite: encode left nodes as 2*v, right nodes as 2*v+1
    from collections import defaultdict

    adj = defaultdict(list)
    for e in range(E):
        l = 2 * int(src[e])
        r = 2 * int(dst[e]) + 1
        adj[l].append(e)
        adj[r].append(e)
    # edge endpoints for walking
    used = np.zeros(E, dtype=bool)
    half = np.zeros(E, dtype=bool)
    ptr = {v: 0 for v in adj}

    other = {}
    for e in range(E):
        other[(e, 2 * int(src[e]))] = 2 * int(dst[e]) + 1
        other[(e, 2 * int(dst[e]) + 1)] = 2 * int(src[e])

    for start in list(adj.keys()):
        while ptr[start] < len(adj[start]):
            e0 = adj[start][ptr[start]]
            if used[e0]:
                ptr[start] += 1
                continue
            # walk a circuit from `start`, alternating halves
            v = start
            flag = False
            while True:
                lst = adj[v]
                while ptr[v] < len(lst) and used[lst[ptr[v]]]:
                    ptr[v] += 1
                if ptr[v] >= len(lst):
                    break
                e = lst[ptr[v]]
                used[e] = True
                half[e] = flag
                flag = not flag
                v = other[(e, v)]
    return half


_color_lib = None
_color_tried = False


def load_fresh_so(so):
    """dlopen `so` bypassing glibc's same-path dedup. After a rebuild
    replaces the file, `ctypes.CDLL(same_path)` can return the OLD
    still-mapped library (glibc matches loaded objects by path string
    before checking inodes), so the rebuilt entry points never appear.
    Copy to a unique temp name, load that, and unlink it (the mapping
    keeps the inode alive). Returns the CDLL or None."""
    import ctypes
    import os
    import shutil
    import tempfile

    try:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(so.parent))
    except OSError:
        return None  # unwritable csrc/: degrade to the no-native-lib path
    os.close(fd)
    try:
        shutil.copy2(so, tmp)
        return ctypes.CDLL(tmp)
    except OSError:
        return None
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _get_color_lib():
    global _color_lib, _color_tried
    if _color_lib is not None or _color_tried:
        return _color_lib
    _color_tried = True
    import ctypes
    import subprocess
    from pathlib import Path

    csrc = Path(__file__).resolve().parent.parent.parent / "csrc"
    so = csrc / "liboarfish_color.so"

    def build() -> bool:
        """Compile to a temp path and replace atomically on success, so
        a failed rebuild never destroys a working (if stale) library."""
        import os

        tmp = so.with_suffix(".so.new")
        try:
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                 str(csrc / "euler_color.cpp"), "-o", str(tmp),
                 "-pthread"],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, so)
            return True
        except Exception:  # noqa: BLE001
            tmp.unlink(missing_ok=True)
            return False

    if not so.exists() and not build():
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    if not hasattr(lib, "oarfish_route_tables_pair"):
        # stale library from before the newest entry point: rebuild,
        # and load the result through a unique temp copy — re-opening
        # the replaced path would hand back the stale mapping
        # (glibc dlopen path-string dedup)
        del lib
        if not build():
            return None
        lib = load_fresh_so(so)
        if lib is None or not hasattr(lib, "oarfish_route_tables_pair"):
            return None
    lib.oarfish_edge_color.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.oarfish_edge_color_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.oarfish_edge_color_batch.restype = ctypes.c_int64
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.oarfish_route_tables.argtypes = [
        ctypes.POINTER(ctypes.c_int64),  # out_idx
        ctypes.POINTER(ctypes.c_int64),  # in_idx
        ctypes.c_int64,                  # E
        ctypes.c_int32,                  # CR
        ctypes.c_int32,                  # n_src
        ctypes.c_int32,                  # n_dst
        ctypes.c_int32,                  # Q
        ctypes.c_int32,                  # n_threads
        i8p, i8p, i8p, i8p,              # s1 tables (s1_src nullable)
        i8p, i8p, i8p, i8p, i8p,         # s3 tables
    ]
    lib.oarfish_route_tables.restype = ctypes.c_int64
    lib.oarfish_route_tables_pair.argtypes = (
        lib.oarfish_route_tables.argtypes + [i8p] * 9
    )
    lib.oarfish_route_tables_pair.restype = ctypes.c_int64
    _color_lib = lib
    return lib


def route_tables_native(out_idx, in_idx, CR, n_src, n_dst, Q, tables):
    """Fill GlobalRoute's nine int8 routing tables in one threaded C++
    call (counting-sort flow ranks + per-chunk 128-edge-coloring + table
    scatters); `tables` is the (s1_r1, s1_src|None, s1_row, s1_r2,
    s3_r1, s3_src, s3_row, s3_r2, s3_mask) tuple of ZEROED C-contiguous
    int8 arrays. Returns False when the native library is unavailable
    (caller falls back to the NumPy path); raises on contract
    violations (flow > Q / chunk id out of range)."""
    lib = _get_color_lib()
    if lib is None or not hasattr(lib, "oarfish_route_tables"):
        return False
    import ctypes

    i8p = ctypes.POINTER(ctypes.c_int8)

    def p8(a):
        return None if a is None else a.ctypes.data_as(i8p)

    oi = np.ascontiguousarray(out_idx, dtype=np.int64)
    ii = np.ascontiguousarray(in_idx, dtype=np.int64)
    rc = lib.oarfish_route_tables(
        oi.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ii.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(oi), int(CR), int(n_src), int(n_dst), int(Q), 0,
        *[p8(t) for t in tables],
    )
    if rc != 0:
        raise ValueError(
            f"route_tables_native: contract violation (code {rc}): "
            f"geometry n_src={n_src} n_dst={n_dst} Q={Q} CR={CR}"
        )
    return True


def route_tables_pair_native(out_idx, in_idx, CR, n_src, n_dst, Q,
                             tables_fwd, tables_rev):
    """Fill BOTH routes of a forward/reverse pair in one threaded C++
    call: `tables_fwd` for out_idx <- in_idx with geometry
    (n_src, n_dst, Q), `tables_rev` for the reversed map with geometry
    (n_dst, n_src, Q). The reverse reuses the forward's counting sorts
    and per-chunk edge colorings (the channel graphs are identical with
    direction flipped), cutting the build ~2x vs two single calls.
    Same table tuple layout / zeroing contract as route_tables_native;
    returns False when the native library is unavailable."""
    lib = _get_color_lib()
    if lib is None or not hasattr(lib, "oarfish_route_tables_pair"):
        return False
    import ctypes

    i8p = ctypes.POINTER(ctypes.c_int8)

    def p8(a):
        return None if a is None else a.ctypes.data_as(i8p)

    oi = np.ascontiguousarray(out_idx, dtype=np.int64)
    ii = np.ascontiguousarray(in_idx, dtype=np.int64)
    rc = lib.oarfish_route_tables_pair(
        oi.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ii.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(oi), int(CR), int(n_src), int(n_dst), int(Q), 0,
        *[p8(t) for t in tables_fwd],
        *[p8(t) for t in tables_rev],
    )
    if rc != 0:
        raise ValueError(
            f"route_tables_pair_native: contract violation (code {rc}):"
            f" geometry n_src={n_src} n_dst={n_dst} Q={Q} CR={CR}"
        )
    return True


def edge_color_bipartite(
    src: np.ndarray, dst: np.ndarray, colors: int
) -> np.ndarray:
    """Color edges of a `colors`-regular bipartite multigraph so that no
    two edges at a node share a color. `colors` must be a power of two."""
    lib = _get_color_lib()
    if lib is not None:
        import ctypes

        s32 = np.ascontiguousarray(src, dtype=np.int32)
        d32 = np.ascontiguousarray(dst, dtype=np.int32)
        out = np.zeros(len(src), dtype=np.int32)
        lib.oarfish_edge_color(
            s32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            d32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(src),
            int(s32.max()) + 1 if len(s32) else 1,
            int(d32.max()) + 1 if len(d32) else 1,
            int(colors),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out.astype(np.int64)
    E = len(src)
    color = np.zeros(E, dtype=np.int64)
    # recursion via explicit stack of (edge_indices, bit)
    stack = [(np.arange(E), colors)]
    while stack:
        idx, c = stack.pop()
        if c == 1 or len(idx) == 0:
            continue
        half = _euler_split(src[idx], dst[idx], c)
        hi = idx[half]
        lo = idx[~half]
        color[hi] += c // 2
        stack.append((lo, c // 2))
        stack.append((hi, c // 2))
    return color


def edge_color_batch(
    src: np.ndarray,
    dst: np.ndarray,
    offsets: np.ndarray,
    n_nodes: int,
    colors: int,
    threads: int = 0,
) -> np.ndarray:
    """Color many independent irregular bipartite multigraphs: graph g's
    DATA edges are `src/dst[offsets[g]:offsets[g+1]]` over `n_nodes`
    nodes per side with max degree <= colors; each graph is padded to
    `colors`-regular internally (Konig) and the graphs run in parallel
    (C++ thread pool). Returns per-edge colors (int32); empty graphs
    contribute nothing. This is the GlobalRoute layout-build hot path."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.zeros(len(src), dtype=np.int32)
    n_graphs = len(offsets) - 1
    if n_graphs <= 0 or len(src) == 0:
        return out
    lib = _get_color_lib()
    s32 = np.ascontiguousarray(src, dtype=np.int32)
    d32 = np.ascontiguousarray(dst, dtype=np.int32)
    if lib is not None:
        import ctypes

        rc = lib.oarfish_edge_color_batch(
            s32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            d32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_graphs,
            int(n_nodes),
            int(colors),
            int(threads),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:
            raise ValueError(
                f"edge_color_batch: graph {rc - 1} violates the "
                f"degree<={colors} / node-id<{n_nodes} contract"
            )
        return out
    # pure-python fallback: regularize + color per graph
    res = np.zeros(len(src), dtype=np.int32)
    for g in range(n_graphs):
        lo, hi = int(offsets[g]), int(offsets[g + 1])
        if hi <= lo:
            continue
        sg, dg = s32[lo:hi], d32[lo:hi]
        deg_l = np.bincount(sg, minlength=n_nodes)
        deg_r = np.bincount(dg, minlength=n_nodes)
        extra_l = np.repeat(np.arange(n_nodes), colors - deg_l)
        extra_r = np.repeat(np.arange(n_nodes), colors - deg_r)
        col = edge_color_bipartite(
            np.concatenate([sg, extra_l]),
            np.concatenate([dg, extra_r]),
            colors,
        )
        res[lo:hi] = col[: hi - lo]
    return res


@dataclass(frozen=True)
class TilePermutePlan:
    """Static three-stage routing for `out[p] = in[perm[p]]` on [R,128].

    Stage arrays are lane indices for `take_along_axis(axis=1)` plus the
    column-stage row-routing expressed as a per-column permutation, itself
    decomposed for the transpose trick (see `static_permute`)."""

    r1: np.ndarray  # [R,128] lane gather for stage 1
    col_perm: np.ndarray  # [R,128]: row index each (row,lane) pulls from
    r2: np.ndarray  # [R,128] lane gather for stage 3
    rows: int

    @staticmethod
    def build(perm: np.ndarray, rows: int) -> "TilePermutePlan":
        """`perm[p]` = source flat position for output flat position p,
        over a [rows,128] tile (flattened row-major)."""
        R = rows
        assert len(perm) == R * LANES
        out_pos = np.arange(R * LANES)
        src_pos = perm
        src_row, src_lane = src_pos // LANES, src_pos % LANES
        dst_row, dst_lane = out_pos // LANES, out_pos % LANES

        # edge coloring: color = intermediate column for each element
        color = edge_color_bipartite(src_row, dst_row, LANES)

        # R1: within source row, element at src_lane moves to lane color
        # r1 gather form: r1[row, lane] = source lane whose element lands
        # in `lane` of that row after stage 1
        r1 = np.zeros((R, LANES), dtype=np.int32)
        r1[src_row, color] = src_lane

        # C: within column `color`, the element moves from src_row to
        # dst_row. Gather form: col_perm[row, lane] = source row feeding
        # (row, lane) after stage 2.
        col_perm = np.zeros((R, LANES), dtype=np.int32)
        col_perm[dst_row, color] = src_row

        # R2: within dest row, element sits at lane `color`, must reach
        # dst_lane: r2[row, lane] = the stage-2 lane feeding final `lane`
        r2 = np.zeros((R, LANES), dtype=np.int32)
        r2[dst_row, dst_lane] = color

        return TilePermutePlan(r1=r1, col_perm=col_perm, r2=r2, rows=R)

    def apply_numpy(self, x: np.ndarray) -> np.ndarray:
        """Reference application (for tests): x flat [R*128]."""
        t = x.reshape(self.rows, LANES)
        s1 = np.take_along_axis(t, self.r1, axis=1)
        s2 = np.take_along_axis(s1, self.col_perm, axis=0)
        s3 = np.take_along_axis(s2, self.r2, axis=1)
        return s3.reshape(-1)
