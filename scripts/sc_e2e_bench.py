"""Single-cell e2e benchmark at the 100k-cell scale (VERDICT r2 item 4).

Generates a CB-collated synthetic BAM (vectorized record assembly — the
bulk e2e generator plus a CB:Z: tag, reads emitted cell-contiguous),
runs the REAL single-cell driver end-to-end (decode -> per-barcode CSR
-> pow2-bucketed batched cell EMs -> .count.mtx/.barcodes/.features
writers), and reports wall, cells/s, phase attribution, and peak RSS.
The reference runs this mode as a worker-thread pool of scalar EMs
(`single_cell.rs:91-193`); its README claims no number here, so this is
our own scaling evidence.

Usage: python scripts/sc_e2e_bench.py [--cells 100000]
           [--reads-per-cell 50] [--txps 30000] [--quick]
"""

import argparse
import json
import logging
import struct
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from e2e_bench import BGZF_EOF, _compress_payload, _put_i32, _put_u16

BCLEN = 16


def build_sc_bam(path, C, reads_per_cell, T, seed=0, mean_k=2,
                 chunk_reads=100_000):
    """CB-collated synthetic BAM: C cells x ~reads_per_cell reads,
    ~mean_k same-span alignments per read, zipf transcript popularity,
    16-base barcodes derived from the cell index. Reads are emitted in
    cell order, so the file is CB-collated as the driver requires
    (`alignment_parser.rs:170-299` semantics)."""
    rng = np.random.default_rng(seed)
    R = C * reads_per_cell
    t_len = rng.integers(400, 4000, size=T).astype(np.int64)
    text = "@HD\tVN:1.6\tSO:unsorted\n@PG\tID:minimap2\tPN:minimap2\n"
    hdr = bytearray()
    hdr += b"BAM\x01"
    tb = text.encode()
    hdr += struct.pack("<i", len(tb)) + tb
    hdr += struct.pack("<i", T)
    for i in range(T):
        nb = (b"t%06d" % i) + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb
        hdr += struct.pack("<i", int(t_len[i]))

    n_pool = 8 << 20
    pool_bytes = (
        rng.integers(0, 4, size=n_pool) * 16
        + rng.integers(0, 4, size=n_pool)
    ).astype(np.uint8)
    filler = None

    NAME_LEN = 11
    CIG = 12
    FIXED = 4 + 32 + NAME_LEN + CIG
    TAGS = 7 + 3 + BCLEN + 1  # AS:i:<i32> + CB:Z:<16>NUL
    CB_OFF = 7  # CB tag starts after AS

    base_lut = np.frombuffer(b"ACGT", dtype=np.uint8)

    total_alns = 0
    t0 = time.perf_counter()
    with open(path, "wb") as fh, ThreadPoolExecutor(4) as tpool:
        harr = np.frombuffer(bytes(hdr), dtype=np.uint8)
        _compress_payload(fh, harr, tpool)
        for lo in range(0, R, chunk_reads):
            hi = min(lo + chunk_reads, R)
            n_r = hi - lo
            sizes = rng.geometric(1.0 / mean_k, size=n_r).clip(1, 20)
            A = int(sizes.sum())
            total_alns += A
            read_idx = np.repeat(np.arange(lo, hi, dtype=np.int64), sizes)
            cell_idx = read_idx // reads_per_cell
            first = np.ones(A, dtype=bool)
            first[1:] = read_idx[1:] != read_idx[:-1]
            tid = (rng.zipf(1.3, size=A) % T).astype(np.int64)
            span_r = rng.integers(200, 380, size=n_r)
            span = np.repeat(span_r, sizes)
            tl = t_len[tid]
            pos = (rng.random(A) * np.maximum(tl - span, 1)).astype(
                np.int64
            )
            score = span - rng.integers(0, 10, size=A)
            l_seq = np.where(first, span + 21, 0).astype(np.int64)
            seq_bytes = (l_seq + 1) // 2 + l_seq
            rec_len = FIXED + seq_bytes + TAGS
            offs = np.zeros(A + 1, dtype=np.int64)
            np.cumsum(rec_len, out=offs[1:])
            need = int(offs[-1])
            if filler is None or len(filler) < need:
                filler = np.tile(pool_bytes, need // n_pool + 1)
            buf = filler[:need]
            o = offs[:-1]
            _put_i32(buf, o, rec_len - 4)
            _put_i32(buf, o + 4, tid)
            _put_i32(buf, o + 8, pos)
            buf[o + 12] = NAME_LEN
            buf[o + 13] = 60
            _put_u16(buf, o + 14, np.zeros(A, np.int64))
            _put_u16(buf, o + 16, np.full(A, 3, np.int64))
            _put_u16(buf, o + 18, np.where(first, 0, 256))
            _put_i32(buf, o + 20, l_seq)
            _put_i32(buf, o + 24, np.full(A, -1, np.int64))
            _put_i32(buf, o + 28, np.full(A, -1, np.int64))
            _put_i32(buf, o + 32, np.zeros(A, np.int64))
            buf[o + 36] = ord("r")
            for k in range(9):
                buf[o + 37 + k] = (
                    (read_idx // 10 ** (8 - k)) % 10 + ord("0")
                )
            _put_i32(buf, o + 47, np.full(A, (12 << 4) | 4, np.int64))
            _put_i32(buf, o + 51, (span.astype(np.int64) << 4) | 0)
            _put_i32(buf, o + 55, np.full(A, (9 << 4) | 4, np.int64))
            to = offs[1:] - TAGS
            buf[to] = ord("A")
            buf[to + 1] = ord("S")
            buf[to + 2] = ord("i")
            _put_i32(buf, to + 3, score)
            cb = to + CB_OFF
            buf[cb] = ord("C")
            buf[cb + 1] = ord("B")
            buf[cb + 2] = ord("Z")
            # 16 base-4 digits of the cell index, MSB first
            for k in range(BCLEN):
                dig = (cell_idx >> (2 * (BCLEN - 1 - k))) & 3
                buf[cb + 3 + k] = base_lut[dig]
            buf[cb + 3 + BCLEN] = 0
            _compress_payload(fh, buf, tpool)
        fh.write(BGZF_EOF)
    return total_alns, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=100_000)
    ap.add_argument("--reads-per-cell", type=int, default=50)
    ap.add_argument("--txps", type=int, default=30_000)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    if args.quick:
        args.cells, args.reads_per_cell, args.txps = 2000, 30, 5000

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    from oarfish_tpu.cli import enable_persistent_jax_cache

    enable_persistent_jax_cache()

    C, T = args.cells, args.txps
    bam = Path(f"/tmp/oarfish_sc_C{C}_r{args.reads_per_cell}_T{T}.bam")
    if bam.exists():
        gen_s, A = 0.0, json.loads(
            bam.with_suffix(".json").read_text()
        )["A"]
    else:
        A, gen_s = build_sc_bam(bam, C, args.reads_per_cell, T)
        bam.with_suffix(".json").write_text(json.dumps({"A": A}))
    sys.stderr.write(
        f"fixture: {bam} C={C} rpc={args.reads_per_cell} T={T} A={A} "
        f"{bam.stat().st_size/1e6:.0f}MB (gen {gen_s:.1f}s)\n"
    )

    from oarfish_tpu.config import Args, resolve_filters
    from oarfish_tpu.quant.single_cell import (
        quantify_single_cell_from_collated_bam,
    )

    run_args = Args(
        alignments=bam,
        output=Path("/tmp/oarfish_sc_out"),
        threads=args.threads,
        single_cell=True,
        em_dtype="auto",
    )
    opts = resolve_filters(run_args)

    phases = {}

    class _Cap(logging.Handler):
        def emit(self, record):
            try:
                if record.msg.startswith("phase sc."):
                    name = record.msg.split()[1]
                    phases[name] = round(float(record.args[0]), 2)
            except Exception:  # noqa: BLE001
                pass

    cap = _Cap()
    logging.getLogger("oarfish_tpu").addHandler(cap)
    t0 = time.perf_counter()
    quantify_single_cell_from_collated_bam(run_args, opts)
    wall = time.perf_counter() - t0
    logging.getLogger("oarfish_tpu").removeHandler(cap)

    import resource

    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    mtx = Path("/tmp/oarfish_sc_out.count.mtx")
    nnz = None
    if mtx.exists():
        with open(mtx) as fh:
            for line in fh:
                if not line.startswith("%"):
                    nnz = int(line.split()[2])
                    break
    print(json.dumps({
        "metric": "sc_e2e_cells_per_s",
        "value": round(C / wall, 1),
        "unit": f"cells/s e2e (C={C}, rpc={args.reads_per_cell}, "
                f"T={T}, A={A})",
        "wall_s": round(wall, 2),
        "cells": C,
        "alignments": A,
        "nnz": nnz,
        "peak_rss_gb": round(rss_gb, 2),
        "phases_s": phases,
        "gen_s": round(gen_s, 1),
    }))


if __name__ == "__main__":
    main()
