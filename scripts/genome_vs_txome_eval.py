"""Genome-mode vs direct-transcriptome consistency eval (VERDICT r4
item 8).

The reference claims genome read-projection "closely tracks direct
transcriptome quantification" (`/root/reference/README.md:229`). This is
testable offline: build a skipped-exon gene world (the
genome_gencode_bench model), simulate reads from known isoforms, then
quantify the SAME reads three ways —

  txome   raw-reads mode vs the transcriptome FASTA (all isoforms)
  genome  genome read-projection mode (annotation + rescue)
  genome --no-rescue

— and report Spearman/MARD between the genome-mode and
transcriptome-mode quant vectors, plus each vs truth.

Usage: python scripts/genome_vs_txome_eval.py [--genes 5000 --reads 30000]
Prints one JSON line.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from genome_gencode_bench import (  # noqa: E402
    build_world, simulate_reads, evaluate,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genes", type=int, default=5_000)
    ap.add_argument("--chroms", type=int, default=4)
    ap.add_argument("--reads", type=int, default=30_000)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--outdir", default="/tmp/oarfish_gvt_eval")
    args = ap.parse_args()

    d = Path(args.outdir)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    iso_seqs = build_world(d, rng, args.genes, args.chroms,
                           sample_genes=range(args.genes))
    simulate_reads(d, rng, iso_seqs, args.reads)
    # transcriptome FASTA over ALL isoforms (raw-reads mode target)
    with open(d / "txome.fa", "wb") as fh:
        for nm in sorted(iso_seqs):
            fh.write(b">" + nm.encode() + b"\n"
                     + iso_seqs[nm].tobytes() + b"\n")
    print(f"world built in {time.time()-t0:.1f}s "
          f"({2*args.genes} isoforms)", file=sys.stderr)

    def run(label, extra):
        cmd = [sys.executable, "-m", "oarfish_tpu",
               "-o", str(d / label), "--em-dtype", "float64", "--quiet",
               "--threads", str(args.threads), *extra]
        r = subprocess.run(
            cmd, cwd=REPO, capture_output=True, text=True, timeout=3600)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-3000:])
            raise SystemExit(1)
        return evaluate(d / f"{label}.quant", d / "truth.tsv")

    res = {}
    tech = ["--seq-tech", "ont-cdna"]
    res["txome"] = run("txome", [
        "--reads", str(d / "reads.fa"), "--annotated", str(d / "txome.fa"),
        *tech])
    res["genome"] = run("genome", [
        "--reads", str(d / "reads.fa"), "--genome", str(d / "genome.fa"),
        "--annotation", str(d / "anno.gtf"), *tech])
    res["genome_norescue"] = run("genome_nr", [
        "--reads", str(d / "reads.fa"), "--genome", str(d / "genome.fa"),
        "--annotation", str(d / "anno.gtf"), "--no-rescue", *tech])

    # mode-vs-mode agreement over all isoforms
    from scipy.stats import spearmanr

    def vec(label):
        est = {}
        with open(d / f"{label}.quant") as fh:
            next(fh)
            for line in fh:
                f = line.rstrip("\n").split("\t")
                est[f[0]] = float(f[2])
        names = sorted(est)
        return names, np.array([est[n] for n in names])

    names_t, v_t = vec("txome")
    names_g, v_g = vec("genome")
    assert names_t == names_g
    both = (v_t + v_g) > 0
    agree_mard = float(np.mean(
        np.abs(v_g[both] - v_t[both]) / (v_g[both] + v_t[both])))
    summary = {
        "protocol": "genome-vs-transcriptome consistency (README.md:229)",
        "genes": args.genes, "reads": args.reads,
        "txome_vs_truth": res["txome"],
        "genome_vs_truth": res["genome"],
        "genome_norescue_vs_truth": res["genome_norescue"],
        "genome_vs_txome_spearman": round(
            float(spearmanr(v_t, v_g).statistic), 4),
        "genome_vs_txome_mard": round(agree_mard, 4),
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
