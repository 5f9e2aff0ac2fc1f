"""Rescue on/off accuracy evidence (VERDICT r1 item 9).

The reference claims soft-clip rescue measurably improves isoform
accuracy in genome mode (`/root/reference/README.md:229`, the bramble
crate's rescue pass). This script quantifies the effect on a simulated
spliced dataset engineered to contain the reads rescue exists for:
reads that end a FEW DOZEN bases past a splice junction — too little
overhang for the spliced chainer to anchor in the next exon, so the
tail soft-clips and, without rescue, the isoforms sharing the aligned
exons tie; the clipped tail's continuation discriminates them.

Design: G genes, each with isoform A = E1+E2+E3 and B = E1+E3 (skipped
exon). Junction-overhang reads from A end 25-60 bp into E2; from B,
25-60 bp into E3. Plus a floor of unambiguous full-isoform reads so the
EM is well-posed. 3% substitutions + 1% indels.

Output: Spearman + MARD vs truth for rescue ON vs --no-rescue, printed
as one JSON line. Run: python scripts/rescue_eval.py [--genes 40]
(host CPU only; jax pinned to cpu).
"""

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def mutate(rng, seq, sub=0.03, indel=0.01):
    out = bytearray()
    bases = b"ACGT"
    for b in seq:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            out.append(bases[rng.integers(4)])
        if rng.random() < sub:
            out.append(bases[rng.integers(4)])
        else:
            out.append(b)
    return bytes(out)


def build_world(d: Path, rng, n_genes):
    e1, e2, e3, gap = 1200, 260, 1200, 1500
    glen = n_genes * (e1 + e2 + e3 + 3 * gap) + gap
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=glen)
    gtf_lines = []
    iso = {}
    pos = gap
    for g in range(n_genes):
        s1, e1e = pos + 1, pos + e1
        pos += e1 + gap
        s2, e2e = pos + 1, pos + e2
        pos += e2 + gap
        s3, e3e = pos + 1, pos + e3
        pos += e3 + gap
        a, b = f"G{g:03d}A", f"G{g:03d}B"
        for nm, exons in ((a, [(s1, e1e), (s2, e2e), (s3, e3e)]),
                          (b, [(s1, e1e), (s3, e3e)])):
            for s, e in exons:
                gtf_lines.append(
                    f'chr1\tt\texon\t{s}\t{e}\t.\t+\t.\t'
                    f'transcript_id "{nm}";'
                )
            iso[nm] = b"".join(
                genome[s - 1 : e].tobytes() for s, e in exons
            )
    (d / "anno.gtf").write_text("\n".join(gtf_lines) + "\n")
    with open(d / "genome.fa", "w") as fh:
        fh.write(">chr1\n")
        gb = genome.tobytes().decode()
        for i in range(0, len(gb), 80):
            fh.write(gb[i : i + 80] + "\n")
    return iso, e1


def simulate_reads(d: Path, rng, iso, e1_len):
    names = sorted(iso)
    truth = {}
    lines = []
    rid = 0
    for nm in names:
        seq = iso[nm]
        # asymmetric within-gene truth: the EM resolves ambiguous reads
        # by abundance, so rescue only shows where the clipped tail is
        # the ONLY evidence against the prior
        n = int(rng.integers(6, 15)) if nm.endswith("A") else int(
            rng.integers(30, 80)
        )
        truth[nm] = 0
        for _ in range(n):
            kind = rng.random()
            if kind < 0.8:
                # junction-overhang read: short span of E1 ending
                # 12-30bp past E1's end (into this isoform's NEXT
                # exon) — too short for the chainer to anchor, so the
                # tail soft-clips and only rescue can read it. Keeping
                # the E1 span short makes the rescued tail a large
                # fraction of the read, so the similarity gap (and the
                # exp(beta*dsim) EM weight ratio) is material.
                start = e1_len - int(rng.integers(150, 321))
                over = int(rng.integers(12, 31))
                frag = seq[start : e1_len + over]
            else:
                # long unambiguous read (covers the discriminating exon
                # structure with solid anchors)
                start = int(rng.integers(0, 200))
                end = len(seq) - int(rng.integers(0, 200))
                frag = seq[start:end]
            frag = mutate(rng, frag)
            lines.append(f">r{rid}\n{frag.decode()}")
            truth[nm] += 1
            rid += 1
    (d / "reads.fa").write_text("\n".join(lines) + "\n")
    with open(d / "truth.tsv", "w") as fh:
        fh.write("name\tcount\n")
        for nm in names:
            fh.write(f"{nm}\t{truth[nm]}\n")
    return truth


def run_cli(d: Path, out, extra):
    import os

    env = dict(os.environ)
    repo = Path(__file__).resolve().parent.parent
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "oarfish_tpu",
         "--reads", str(d / "reads.fa"), "--genome", str(d / "genome.fa"),
         "--annotation", str(d / "anno.gtf"), "--seq-tech", "ont-cdna",
         "-o", str(out), "--em-dtype", "float64", "--quiet",
         "--junc-miss-discount", "0.3", *extra],
        env=env, cwd=repo, capture_output=True, text=True, timeout=900,
    )
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-3000:])
        raise SystemExit(1)


def evaluate(quant_path, truth_path):
    import pandas as pd
    from scipy import stats

    q = pd.read_csv(quant_path, sep="\t").rename(
        columns={"tname": "name", "num_reads": "count"}
    )
    t = pd.read_csv(truth_path, sep="\t")
    m = q.merge(t, on="name", suffixes=("_q", "_t"))
    x, y = m["count_q"].to_numpy(), m["count_t"].to_numpy()
    rho = float(stats.spearmanr(x, y).statistic)
    denom = np.maximum(x + y, 1e-12)
    mard = float(np.mean(np.where(x + y > 0, np.abs(x - y) / denom, 0.0)))
    return {"spearman": round(rho, 4), "mard": round(mard, 4),
            "quantified": round(float(x.sum()), 1),
            "truth_total": int(y.sum())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genes", type=int, default=40)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory() as td:
        d = Path(td)
        iso, e1_len = build_world(d, rng, args.genes)
        truth = simulate_reads(d, rng, iso, e1_len)
        sys.stderr.write(
            f"world: {args.genes} genes, {2*args.genes} isoforms, "
            f"{sum(truth.values())} reads\n"
        )
        run_cli(d, d / "on", [])
        run_cli(d, d / "off", ["--no-rescue"])
        res = {
            "rescue_on": evaluate(d / "on.quant", d / "truth.tsv"),
            "rescue_off": evaluate(d / "off.quant", d / "truth.tsv"),
            "genes": args.genes,
            "reads": sum(truth.values()),
        }
        if args.keep:
            import shutil

            shutil.copytree(d, "/tmp/rescue_eval_world",
                            dirs_exist_ok=True)
        print(json.dumps(res))


if __name__ == "__main__":
    main()
