"""GENCODE-scale genome read-projection benchmark (VERDICT r3 item 5).

The reference's one human-scale perf claim is genome mode
(`/root/reference/README.md:230`): ~80k-read human PacBio HiFi
simulation, <1 min on 48 threads, 24-25 GB peak RSS (rammap DP caches
dominate). This measures OUR genome pipeline at a GENCODE-shaped
synthetic scale: ~250k isoforms (125k 2-isoform genes), ~0.9 Gbp
genome over 25 chromosomes, 80k reads.

World geometry reuses scripts/rescue_eval.py's skipped-exon gene model
(A = E1+E2+E3, B = E1+E3) but the builder is fully vectorized: the
genome is one random-base array per chromosome (written + sliced for
sampled isoforms, then dropped — generator RSS stays at one-chrom
scale), GTF lines are f-string-joined, and read mutation is a
substitutions-only vectorized pass (per-base Python indel loops are
~100x too slow at 160 Mbases; perf benchmark, not an accuracy study).

Reads are sampled Dirichlet(0.8) over the isoforms of a gene subset
(default 5000 genes) so abundance is skewed but truth is dense enough
to score Spearman on the sampled set.

Phases are parsed from the child CLI's `phase genome.*` log lines
(annot = GTF load + junction derivation, index = FASTA read + minimizer
index build + junction load, aux = g2t + rescue DB + store, map =
map+project+filter loop); EM/write ride the shared bulk tail.

Run: python scripts/genome_gencode_bench.py [--genes 125000 --reads 80000]
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

E1, E2, E3, GAP = 1200, 260, 1200, 1500
GENE_SPAN = E1 + E2 + E3 + 3 * GAP  # bp consumed per gene (incl. gaps)
BASES = np.frombuffer(b"ACGT", np.uint8)


def write_fasta_seq(fh, name: str, seq: np.ndarray, width: int = 80):
    """Vectorized 80-column FASTA body write for a uint8 base array."""
    fh.write(b">" + name.encode() + b"\n")
    n = len(seq)
    nrows = (n + width - 1) // width
    pad = nrows * width - n
    mat = np.empty((nrows, width + 1), np.uint8)
    mat[:, width] = ord("\n")
    padded = np.empty(nrows * width, np.uint8)
    padded[:n] = seq
    if pad:
        padded[n:] = ord(" ")  # trimmed below
    mat[:, :width] = padded.reshape(nrows, width)
    body = mat.reshape(-1).tobytes()
    if pad:
        # strip pad spaces from the final row
        body = body[: -(pad + 1)] + b"\n"
    fh.write(body)


def gene_coords(j: int):
    """Exon (start, end) 1-based inclusive coords for within-chrom gene j."""
    base = j * GENE_SPAN + GAP
    s1, e1 = base + 1, base + E1
    base += E1 + GAP
    s2, e2 = base + 1, base + E2
    base += E2 + GAP
    s3, e3 = base + 1, base + E3
    return (s1, e1), (s2, e2), (s3, e3)


def mutate_batch(rng, frags, sub=0.01):
    """Substitutions-only vectorized mutation over a list of uint8 arrays."""
    out = []
    for f in frags:
        m = rng.random(len(f)) < sub
        nm = int(m.sum())
        if nm:
            f = f.copy()
            f[m] = BASES[rng.integers(0, 4, nm)]
        out.append(f)
    return out


def build_world(d: Path, rng, n_genes: int, n_chroms: int, sample_genes):
    """Write genome.fa + anno.gtf; return {iso_name: uint8 seq} for the
    sampled genes only."""
    per_chrom = (n_genes + n_chroms - 1) // n_chroms
    sampled = {}  # gene id -> chrom-local j (filled per chrom)
    for g in sample_genes:
        sampled.setdefault(int(g) // per_chrom, []).append(int(g))
    iso_seqs = {}
    gtf = open(d / "anno.gtf", "w")
    fa = open(d / "genome.fa", "wb")
    for c in range(n_chroms):
        g_lo = c * per_chrom
        g_hi = min(n_genes, g_lo + per_chrom)
        ng = g_hi - g_lo
        if ng <= 0:
            break
        chrom = f"chr{c + 1}"
        clen = ng * GENE_SPAN + GAP
        genome = BASES[rng.integers(0, 4, clen)]
        write_fasta_seq(fa, chrom, genome)
        lines = []
        for j in range(ng):
            (s1, e1), (s2, e2), (s3, e3) = gene_coords(j)
            a, b = f"G{g_lo + j:06d}A", f"G{g_lo + j:06d}B"
            for nm, exons in ((a, ((s1, e1), (s2, e2), (s3, e3))),
                              (b, ((s1, e1), (s3, e3)))):
                for s, e in exons:
                    lines.append(
                        f'{chrom}\tt\texon\t{s}\t{e}\t.\t+\t.\t'
                        f'transcript_id "{nm}";'
                    )
        gtf.write("\n".join(lines) + "\n")
        for g in sampled.get(c, ()):
            j = g - g_lo
            (s1, e1), (s2, e2), (s3, e3) = gene_coords(j)
            ex = [genome[s1 - 1:e1], genome[s2 - 1:e2], genome[s3 - 1:e3]]
            iso_seqs[f"G{g:06d}A"] = np.concatenate(ex)
            iso_seqs[f"G{g:06d}B"] = np.concatenate([ex[0], ex[2]])
        del genome
    gtf.close()
    fa.close()
    return iso_seqs


def simulate_reads(d: Path, rng, iso_seqs, n_reads: int):
    names = sorted(iso_seqs)
    p = rng.dirichlet(np.ones(len(names)) * 0.8)
    picks = rng.choice(len(names), size=n_reads, p=p)
    truth = {nm: 0 for nm in names}
    with open(d / "reads.fa", "wb") as fh:
        for rid, k in enumerate(picks):
            nm = names[int(k)]
            seq = iso_seqs[nm]
            span = int(rng.integers(min(400, len(seq) // 2), len(seq) + 1))
            pos = int(rng.integers(0, len(seq) - span + 1))
            frag = mutate_batch(rng, [seq[pos:pos + span]])[0]
            fh.write(b">r%d\n" % rid + frag.tobytes() + b"\n")
            truth[nm] += 1
    with open(d / "truth.tsv", "w") as fh:
        fh.write("name\tcount\n")
        for nm in names:
            fh.write(f"{nm}\t{truth[nm]}\n")
    return truth


def evaluate(quant_path: Path, truth_path: Path):
    from scipy.stats import spearmanr

    est = {}
    with open(quant_path) as fh:
        next(fh)
        for line in fh:
            f = line.rstrip("\n").split("\t")
            est[f[0]] = float(f[2])
    tr = {}
    with open(truth_path) as fh:
        next(fh)
        for line in fh:
            nm, c = line.rstrip("\n").split("\t")
            tr[nm] = float(c)
    names = sorted(tr)
    t = np.array([tr[n] for n in names])
    e = np.array([est.get(n, 0.0) for n in names])
    rho = float(spearmanr(t, e).statistic)
    nz = t > 0
    mard = float(np.mean(np.abs(e[nz] - t[nz]) / (e[nz] + t[nz])))
    return {"spearman": round(rho, 4), "mard": round(mard, 4),
            "quantified": int((e > 0).sum())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genes", type=int, default=125_000)
    ap.add_argument("--chroms", type=int, default=25)
    ap.add_argument("--reads", type=int, default=80_000)
    ap.add_argument("--sample-genes", type=int, default=5_000)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--keep-dir", type=str, default=None,
                    help="build the world here and keep it (reuse with "
                    "--reuse-dir on later runs)")
    ap.add_argument("--reuse-dir", type=str, default=None)
    ap.add_argument("--index-out", type=str, default=None,
                    help="persist the genome index during the run")
    ap.add_argument("--genome-index", type=str, default=None,
                    help="quantify against this prebuilt index instead "
                    "of the FASTA (skips the index build)")
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
        sample = rng.choice(args.genes, size=min(args.sample_genes,
                                                 args.genes), replace=False)
        iso = build_world(d, rng, args.genes, args.chroms, sample)
        simulate_reads(d, rng, iso, args.reads)
        gen_s = time.perf_counter() - t_gen

    env = dict(os.environ)
    repo = Path(__file__).resolve().parent.parent
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    rss0 = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "oarfish_tpu",
           "--reads", str(d / "reads.fa"),
           "--genome", args.genome_index or str(d / "genome.fa"),
           "--annotation", str(d / "anno.gtf"),
           "--seq-tech", "ont-cdna",
           "--threads", str(args.threads),
           "--junc-miss-discount", "0.3",
           "-o", str(d / "out")]
    if args.index_out:
        cmd += ["--index-out", args.index_out]
    r = subprocess.run(
        cmd, env=env, cwd=repo, capture_output=True, text=True,
        timeout=7200,
    )
    wall = time.perf_counter() - t0
    sys.stderr.write(r.stderr[-4000:])
    if r.returncode != 0:
        raise SystemExit(1)
    rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    phases = {
        m.group(1): float(m.group(2))
        for m in re.finditer(r"phase (genome\.[\w.]+) ([0-9.]+)", r.stderr)
    }
    acc = evaluate(d / "out.quant", d / "truth.tsv")
    if td_ctx:
        td_ctx.cleanup()
    print(json.dumps({
        "metric": "genome_gencode_wall_s",
        "value": round(wall, 2),
        "reads": args.reads,
        "isoforms": 2 * args.genes,
        "genome_gbp": round(args.genes * GENE_SPAN / 1e9, 3),
        "threads": args.threads,
        "map_reads_per_s": round(
            args.reads / phases["genome.map"], 1
        ) if "genome.map" in phases else None,
        "phases_s": {k: round(v, 2) for k, v in sorted(phases.items())},
        "peak_rss_gb": round(max(rss, rss0) / 1e6, 2),
        **acc,
        "gen_s": round(gen_s, 1),
    }))


if __name__ == "__main__":
    main()
