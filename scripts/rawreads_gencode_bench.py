"""Raw-reads (transcriptome) mode at GENCODE scale (VERDICT r3 item 5,
the transcriptome half).

Builds a ~250k-transcript synthetic transcriptome (lognormal lengths
~1.3kb mean, ~330 Mbp total — GENCODE-shaped), simulates reads with
substitutions, and times the full CLI raw-reads pipeline (index build
or prebuilt-index load + map/rescore + filter + EM + write) in a child
process. Phases come from the driver's `phase rawreads.*` log lines.

Run: python scripts/rawreads_gencode_bench.py [--txps 250000 --reads 80000]
Optional: --index-out IDX (persist), --index IDX (prebuilt; skips build).
Prints one JSON line. Host CPU only.
"""

import argparse
import json
import re
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BASES = np.frombuffer(b"ACGT", np.uint8)


def build_transcriptome(d: Path, rng, n_txps: int):
    lens = np.clip(
        rng.lognormal(7.0, 0.55, n_txps), 300, 12_000
    ).astype(np.int64)
    offs = np.zeros(n_txps + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    blob = BASES[rng.integers(0, 4, int(offs[-1]))]
    with open(d / "txps.fa", "wb") as fh:
        for i in range(n_txps):
            seq = blob[offs[i]:offs[i + 1]]
            fh.write(b">T%06d\n" % i)
            fh.write(seq.tobytes() + b"\n")
    return blob, offs, lens


def simulate_reads(d: Path, rng, blob, offs, lens, n_reads: int,
                   n_expressed: int):
    expr = rng.choice(len(lens), size=n_expressed, replace=False)
    p = rng.dirichlet(np.ones(n_expressed) * 0.8)
    picks = expr[rng.choice(n_expressed, size=n_reads, p=p)]
    truth = np.zeros(len(lens), np.int64)
    with open(d / "reads.fa", "wb") as fh:
        for rid, t in enumerate(picks):
            t = int(t)
            L = int(lens[t])
            span = int(rng.integers(min(400, L // 2), L + 1))
            pos = int(rng.integers(0, L - span + 1))
            frag = blob[offs[t] + pos:offs[t] + pos + span].copy()
            m = rng.random(span) < 0.01
            nm = int(m.sum())
            if nm:
                frag[m] = BASES[rng.integers(0, 4, nm)]
            truth[t] += 1
            fh.write(b">r%d\n" % rid + frag.tobytes() + b"\n")
    np.savetxt(d / "truth.tsv", np.c_[np.arange(len(lens)), truth],
               fmt="%d", delimiter="\t")
    return truth


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--txps", type=int, default=250_000)
    ap.add_argument("--reads", type=int, default=80_000)
    ap.add_argument("--expressed", type=int, default=10_000)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--keep-dir", type=str, default=None)
    ap.add_argument("--reuse-dir", type=str, default=None)
    ap.add_argument("--index-out", type=str, default=None)
    ap.add_argument("--index", type=str, default=None)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    import os

    td_ctx = None
    if args.reuse_dir:
        d = Path(args.reuse_dir)
        gen_s = 0.0
    else:
        if args.keep_dir:
            d = Path(args.keep_dir)
            d.mkdir(parents=True, exist_ok=True)
        else:
            td_ctx = tempfile.TemporaryDirectory()
            d = Path(td_ctx.name)
        t_gen = time.perf_counter()
        blob, offs, lens = build_transcriptome(d, rng, args.txps)
        simulate_reads(d, rng, blob, offs, lens, args.reads,
                       args.expressed)
        del blob
        gen_s = time.perf_counter() - t_gen

    env = dict(os.environ)
    repo = Path(__file__).resolve().parent.parent
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    ref_args = (["--index", args.index] if args.index
                else ["--annotated", str(d / "txps.fa")])
    if args.index_out:
        ref_args += ["--index-out", args.index_out]
    rss0 = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "oarfish_tpu",
         "--reads", str(d / "reads.fa"), *ref_args,
         "--seq-tech", "ont-cdna",
         "--threads", str(args.threads),
         "-o", str(d / "out")],
        env=env, cwd=repo, capture_output=True, text=True, timeout=7200,
    )
    wall = time.perf_counter() - t0
    sys.stderr.write(r.stderr[-4000:])
    if r.returncode != 0:
        raise SystemExit(1)
    rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    phases = {
        m.group(1): float(m.group(2))
        for m in re.finditer(r"phase (rawreads\.\w+) ([0-9.]+)", r.stderr)
    }

    from scipy.stats import spearmanr

    truth = np.loadtxt(d / "truth.tsv", delimiter="\t")[:, 1]
    est = np.zeros(args.txps)
    with open(d / "out.quant") as fh:
        next(fh)
        for line in fh:
            f = line.rstrip("\n").split("\t")
            est[int(f[0][1:])] = float(f[2])
    rho = float(spearmanr(truth, est).statistic)
    nz = truth > 0
    mard = float(np.mean(np.abs(est[nz] - truth[nz]) /
                         (est[nz] + truth[nz])))
    if td_ctx:
        td_ctx.cleanup()
    print(json.dumps({
        "metric": "rawreads_gencode_wall_s",
        "value": round(wall, 2),
        "reads": args.reads,
        "txps": args.txps,
        "threads": args.threads,
        "map_reads_per_s": round(
            args.reads / phases["rawreads.map"], 1
        ) if "rawreads.map" in phases else None,
        "phases_s": {k: round(v, 2) for k, v in sorted(phases.items())},
        "peak_rss_gb": round(max(rss, rss0) / 1e6, 2),
        "spearman": round(rho, 4),
        "mard": round(mard, 4),
        "gen_s": round(gen_s, 1),
    }))


if __name__ == "__main__":
    main()
