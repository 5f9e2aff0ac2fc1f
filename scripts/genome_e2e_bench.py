"""Genome read-projection e2e benchmark: wall time + peak RSS + accuracy.

The reference's only concrete performance claims are genome-mode
(`/root/reference/README.md:230`): ~80k-read human PacBio HiFi
simulation in <1 min on 48 threads with ~24-25 GB peak RSS (mapper DP
caches dominate the footprint). This measures OUR genome read-
projection pipeline on a simulated spliced dataset at the same read
count: full CLI run (map + project + rescue + filter + EM + write) in
a child process, reporting wall seconds, the child's peak RSS, and
Spearman vs the simulation truth. Host CPU only (the reference is
CPU-only; the EM at this scale runs on the host backend anyway).

Run: python scripts/genome_e2e_bench.py [--reads 80000 --genes 300]
Prints one JSON line.
"""

import argparse
import json
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rescue_eval import build_world, evaluate, mutate  # noqa: E402


def simulate_reads(d: Path, rng, iso, n_reads):
    names = sorted(iso)
    truth = {nm: 0 for nm in names}
    p = rng.dirichlet(np.ones(len(names)) * 0.8)
    with open(d / "reads.fa", "w") as fh:
        for rid in range(n_reads):
            nm = names[int(rng.choice(len(names), p=p))]
            seq = iso[nm]
            span = int(rng.integers(min(400, len(seq) // 2), len(seq) + 1))
            pos = int(rng.integers(0, len(seq) - span + 1))
            frag = mutate(rng, seq[pos : pos + span], sub=0.01, indel=0.005)
            fh.write(f">r{rid}\n{frag.decode()}\n")
            truth[nm] += 1
    with open(d / "truth.tsv", "w") as fh:
        fh.write("name\tcount\n")
        for nm in names:
            fh.write(f"{nm}\t{truth[nm]}\n")
    return truth


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=80_000)
    ap.add_argument("--genes", type=int, default=300)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    import os

    with tempfile.TemporaryDirectory() as td:
        d = Path(td)
        iso, _e1 = build_world(d, rng, args.genes)
        truth = simulate_reads(d, rng, iso, args.reads)
        env = dict(os.environ)
        repo = Path(__file__).resolve().parent.parent
        env["PYTHONPATH"] = str(repo) + os.pathsep + env.get(
            "PYTHONPATH", ""
        )
        rss0 = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "oarfish_tpu",
             "--reads", str(d / "reads.fa"),
             "--genome", str(d / "genome.fa"),
             "--annotation", str(d / "anno.gtf"),
             "--seq-tech", "ont-cdna",
             "--threads", str(args.threads),
             # skip-junction reads tie their isoform pair without the
             # missed-junction discount (see scripts/rescue_eval.py)
             "--junc-miss-discount", "0.3",
             "-o", str(d / "out"), "--quiet"],
            env=env, cwd=repo, capture_output=True, text=True,
            timeout=3000,
        )
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-3000:])
            raise SystemExit(1)
        rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
        acc = evaluate(d / "out.quant", d / "truth.tsv")
        print(json.dumps({
            "metric": "genome_e2e_wall_s",
            "value": round(wall, 2),
            "reads": args.reads,
            "isoforms": 2 * args.genes,
            "threads": args.threads,
            "reads_per_s": round(args.reads / wall, 1),
            "peak_rss_gb": round(max(rss, rss0) / 1e6, 2),
            "spearman": acc["spearman"],
            "mard": acc["mard"],
            "truth_total": sum(truth.values()),
            "quantified": acc["quantified"],
        }))


if __name__ == "__main__":
    main()
