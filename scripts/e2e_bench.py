"""End-to-end BAM -> quant.tsv benchmark with host/device attribution.

Measures the FULL pipeline the reference times as a single run
(`bulk.rs:212-259`): BGZF/BAM decode, filtering/packing, EM inference,
and output writing, on a synthetic name-collated BAM at a configurable
scale (default R=2M reads, T=200k transcripts, ~3 alignments/read —
the BASELINE config-3 shape). The fixture is generated once (vectorized
numpy record assembly + threaded BGZF deflate) and cached in /tmp.

Phases reported:
  gen_s        one-time fixture generation (excluded from e2e wall)
  pack_s       decode + filter + coverage + CSR (overlapped streaming)
    decode_wait_s / filter_s   attribution within pack (sum > wall when
                               the overlap is working)
  infer_cold_s first inference incl. route build + jit compile
  infer_warm_s second inference in the same process (jit caches warm)
  route_build_s / em_s / em_iters   captured from the driver's logs
  write_s      quant/meta/ambig writers (inside infer, attributed)

Usage: python scripts/e2e_bench.py [--reads 2000000] [--quick]
                                   [--impl auto|fast|v4] [--json]
"""

import argparse
import json
import os
import logging
import struct
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


# ---------------------------------------------------------------------------
# Vectorized synthetic BAM generation
# ---------------------------------------------------------------------------

def _compress_payload(fh, payload: np.ndarray, pool, level=1):
    """BGZF-compress a uint8 payload array in 64KB blocks on `pool`."""
    mv = memoryview(payload.tobytes())
    blocks = [mv[i : i + 0xFF00] for i in range(0, len(mv), 0xFF00)]

    def one(b):
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        comp = co.compress(b) + co.flush()
        bsize = len(comp) + 12 + 6 + 8
        header = (
            b"\x1f\x8b\x08\x04" + b"\x00\x00\x00\x00" + b"\x00\xff"
            + struct.pack("<H", 6) + b"BC" + struct.pack("<H", 2)
            + struct.pack("<H", bsize - 1)
        )
        trailer = struct.pack(
            "<II", zlib.crc32(b), len(b) & 0xFFFFFFFF
        )
        return header + comp + trailer

    for out in pool.map(one, blocks):
        fh.write(out)


def _put_i32(buf, offs, vals):
    v = np.asarray(vals, dtype=np.int64)
    for k in range(4):
        buf[offs + k] = (v >> (8 * k)) & 0xFF


def _put_u16(buf, offs, vals):
    v = np.asarray(vals, dtype=np.int64)
    buf[offs] = v & 0xFF
    buf[offs + 1] = (v >> 8) & 0xFF


def build_e2e_bam(path, R, T, seed=0, mean_k=3, chunk_reads=100_000):
    """Vectorized synthetic collated BAM: R reads, ~mean_k alignments
    each (all alignments of a read share its span, so the 0.95 score
    threshold retains nearly all — post-filter A tracks the generated
    count), zipf-popular transcripts, primaries carry SEQ."""
    rng = np.random.default_rng(seed)
    t_len = rng.integers(2200, 12_000, size=T).astype(np.int64)
    # header
    text = "@HD\tVN:1.6\tSO:unsorted\n@PG\tID:minimap2\tPN:minimap2\n"
    hdr = bytearray()
    hdr += b"BAM\x01"
    tb = text.encode()
    hdr += struct.pack("<i", len(tb)) + tb
    hdr += struct.pack("<i", T)
    for i in range(T):
        nb = (b"t%06d" % i) + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(t_len[i]))

    # seq/qual filler with realistic entropy: 16-symbol bytes, like
    # 2-bit-packed base pairs (4 bits/byte -> deflate ~1.8x, matching
    # real BAM compressibility; pure-random bytes don't compress and
    # a small tiled pool over-compresses)
    n_pool = 8 << 20
    pool_bytes = (
        rng.integers(0, 4, size=n_pool) * 16 + rng.integers(0, 4, size=n_pool)
    ).astype(np.uint8)
    filler = None  # lazily tiled to the largest chunk payload

    NAME_LEN = 11  # 'r' + 9 digits + NUL
    CIG = 12  # 3 ops
    FIXED = 4 + 32 + NAME_LEN + CIG  # through end of cigar
    TAGS = 7  # AS:i:<i32>

    total_alns = 0
    t0 = time.perf_counter()
    with open(path, "wb") as fh, ThreadPoolExecutor(4) as tpool:
        fh.write(bytes(hdr[:0]))  # noop; header compressed below
        harr = np.frombuffer(bytes(hdr), dtype=np.uint8)
        _compress_payload(fh, harr, tpool)
        for lo in range(0, R, chunk_reads):
            hi = min(lo + chunk_reads, R)
            n_r = hi - lo
            sizes = rng.geometric(1.0 / mean_k, size=n_r).clip(1, 50)
            A = int(sizes.sum())
            total_alns += A
            read_idx = np.repeat(np.arange(lo, hi, dtype=np.int64), sizes)
            first = np.ones(A, dtype=bool)
            first[1:] = read_idx[1:] != read_idx[:-1]
            tid = (rng.zipf(1.3, size=A) % T).astype(np.int64)
            span_r = rng.integers(400, 2000, size=n_r)
            span = np.repeat(span_r, sizes)
            tl = t_len[tid]
            pos = (rng.random(A) * (tl - span)).astype(np.int64)
            score = span - rng.integers(0, 20, size=A)
            l_seq = np.where(first, span + 21, 0).astype(np.int64)
            seq_bytes = (l_seq + 1) // 2 + l_seq
            rec_len = FIXED + seq_bytes + TAGS
            offs = np.zeros(A + 1, dtype=np.int64)
            np.cumsum(rec_len, out=offs[1:])
            # the buffer starts as pool-tiled filler: the seq+qual
            # regions (never parsed — the decoder skips them by length
            # arithmetic) keep this content; every structured field is
            # overwritten below. The filler buffer is reused across
            # chunks (stale structured bytes land in seq regions, which
            # is harmless filler).
            need = int(offs[-1])
            if filler is None or len(filler) < need:
                filler = np.tile(pool_bytes, need // n_pool + 1)
            buf = filler[:need]
            o = offs[:-1]
            _put_i32(buf, o, rec_len - 4)  # block_size
            _put_i32(buf, o + 4, tid)
            _put_i32(buf, o + 8, pos)
            buf[o + 12] = NAME_LEN
            buf[o + 13] = 60  # mapq
            _put_u16(buf, o + 14, np.zeros(A, np.int64))  # bin
            _put_u16(buf, o + 16, np.full(A, 3, np.int64))  # n_cigar
            _put_u16(buf, o + 18, np.where(first, 0, 256))  # flag
            _put_i32(buf, o + 20, l_seq)
            _put_i32(buf, o + 24, np.full(A, -1, np.int64))
            _put_i32(buf, o + 28, np.full(A, -1, np.int64))
            _put_i32(buf, o + 32, np.zeros(A, np.int64))
            # name: 'r' + 9 digits + NUL
            buf[o + 36] = ord("r")
            for k in range(9):
                buf[o + 37 + k] = (
                    (read_idx // 10 ** (8 - k)) % 10 + ord("0")
                )
            # cigar: 12S spanM 9S
            _put_i32(buf, o + 47, np.full(A, (12 << 4) | 4, np.int64))
            _put_i32(buf, o + 51, (span.astype(np.int64) << 4) | 0)
            _put_i32(buf, o + 55, np.full(A, (9 << 4) | 4, np.int64))
            # seq+qual regions keep the pool-tiled fill (see above)
            # tags: AS:i:<score>
            to = offs[1:] - TAGS
            buf[to] = ord("A")
            buf[to + 1] = ord("S")
            buf[to + 2] = ord("i")
            _put_i32(buf, to + 3, score)
            _compress_payload(fh, buf, tpool)
        fh.write(BGZF_EOF)
    gen_s = time.perf_counter() - t0
    return total_alns, gen_s


def fixture_path(R, T, seed=0):
    return Path(f"/tmp/oarfish_e2e_R{R}_T{T}_s{seed}.bam")


def ensure_fixture(R, T, seed=0):
    p = fixture_path(R, T, seed)
    meta = p.with_suffix(".json")
    if p.exists() and meta.exists():
        return p, json.loads(meta.read_text()), 0.0
    A, gen_s = build_e2e_bam(p, R, T, seed=seed)
    info = {"R": R, "T": T, "A_generated": A, "bytes": p.stat().st_size}
    meta.write_text(json.dumps(info))
    return p, info, gen_s


# ---------------------------------------------------------------------------
# E2E run with attribution
# ---------------------------------------------------------------------------

class _PhaseCapture(logging.Handler):
    """Capture the driver's phase-timing log records (route build, EM)."""

    def __init__(self):
        super().__init__()
        self.route_build_s = None
        self.em_s = None
        self.em_iters = None
        self.impl = None

    def emit(self, record):
        msg = record.msg
        try:
            if "routing built in" in msg:
                self.impl, self.route_build_s = "v4", float(record.args[0])
            elif "EM converged after" in msg and "iterations in" in msg:
                self.em_iters = int(record.args[0])
                self.em_s = float(record.args[1])
            elif msg.startswith("em-impl auto ->"):
                self.impl = record.args[0]
        except Exception:  # noqa: BLE001 — attribution is best-effort
            pass


def run_once(bam_path, out_prefix, impl="auto", threads=4,
             model_coverage=False):
    from oarfish_tpu.config import Args, resolve_filters
    from oarfish_tpu.quant.bulk import quantify_bulk_alignments_from_bam

    args = Args(
        alignments=Path(bam_path),
        output=Path(out_prefix),
        threads=threads,
        em_dtype="auto",
        em_impl=impl,
        model_coverage=model_coverage,
    )
    opts = resolve_filters(args)
    cap = _PhaseCapture()
    logging.getLogger("oarfish_tpu").addHandler(cap)

    import oarfish_tpu.host.packer as packer_mod

    pack_tm = {}
    orig = packer_mod.pack_bam_fast

    def wrapped(*a, **kw):
        kw["timings"] = pack_tm
        return orig(*a, **kw)

    packer_mod.pack_bam_fast = wrapped
    try:
        t0 = time.perf_counter()
        counts = quantify_bulk_alignments_from_bam(args, opts)
        wall = time.perf_counter() - t0
    finally:
        packer_mod.pack_bam_fast = orig
        logging.getLogger("oarfish_tpu").removeHandler(cap)
    import resource

    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    return {
        "wall_s": round(wall, 3),
        "pack": {k: round(v, 3) if isinstance(v, float) else v
                 for k, v in pack_tm.items()},
        "route_build_s": cap.route_build_s,
        "em_s": cap.em_s,
        "em_iters": cap.em_iters,
        "impl": cap.impl,
        "counts_sum": float(np.sum(counts)),
        "peak_rss_gb": round(peak_rss_gb, 2),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=2_000_000)
    ap.add_argument("--txps", type=int, default=200_000)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--platform", default=None,
                    help="pin jax platform (cpu for offline runs)")
    ap.add_argument("--seed", type=int, default=0,
                    help="fixture seed (different seeds = different BAMs)")
    ap.add_argument("--fresh", action="store_true",
                    help="wipe the plan cache AND the persistent XLA "
                         "cache first (first-ever-run scenario)")
    ap.add_argument("--cov", action="store_true",
                    help="quantify with --model-coverage (BASELINE "
                         "config 2 shape)")
    ap.add_argument("--reps", type=int, default=1,
                    help="warm repetitions; the median is reported "
                         "(VERDICT r3 item 6)")
    args = ap.parse_args()
    if args.quick:
        args.reads, args.txps = 100_000, 20_000

    if args.platform:
        import jax

        # must happen BEFORE backend init
        jax.config.update("jax_platforms", args.platform)

    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    from oarfish_tpu.cli import DEFAULT_JAX_CACHE_DIR, enable_persistent_jax_cache

    enable_persistent_jax_cache()

    if args.fresh:
        import shutil

        for d in (
            os.environ.get("OARFISH_PLAN_CACHE_DIR")
            or str(Path.home() / ".cache" / "oarfish_tpu" / "plans"),
            os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(DEFAULT_JAX_CACHE_DIR),
        ):
            shutil.rmtree(d, ignore_errors=True)
            sys.stderr.write(f"fresh: wiped {d}\n")

    R, T = args.reads, args.txps
    bam_path, info, gen_s = ensure_fixture(R, T, seed=args.seed)
    sys.stderr.write(
        f"fixture: {bam_path} R={R} T={T} A={info['A_generated']} "
        f"{info['bytes']/1e6:.0f}MB (gen {gen_s:.1f}s)\n"
    )

    out = Path("/tmp/oarfish_e2e_out")
    cold = run_once(bam_path, out, impl=args.impl, threads=args.threads,
                    model_coverage=args.cov)
    warms = [
        run_once(bam_path, out, impl=args.impl, threads=args.threads,
                 model_coverage=args.cov)
        for _ in range(max(args.reps, 1))
    ]
    warms.sort(key=lambda r: r["wall_s"])
    warm = warms[len(warms) // 2]

    result = {
        "metric": "e2e_bam_to_quant_s",
        "value": warm["wall_s"],
        "unit": (
            f"s BAM->quant.tsv (R={R}, T={T}, A={info['A_generated']}, "
            f"impl={warm['impl']}, warm jit median of {len(warms)}; "
            f"cold={cold['wall_s']}s, seed={args.seed})"
        ),
        "R": R,
        "A": info["A_generated"],
        "reads_per_s": round(R / warm["wall_s"], 1),
        "cold": cold,
        "warm": warm,
        "warm_walls": [r["wall_s"] for r in warms],
        "gen_s": round(gen_s, 1),
        "seed": args.seed,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
