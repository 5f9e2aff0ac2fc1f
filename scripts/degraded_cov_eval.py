"""Coverage-model VALUE eval on 3'-degraded reads (VERDICT r4 item 2).

The reference's headline modeling claim (`/root/reference/README.md:137-150`)
is that `--model-coverage` improves multimapping resolution when the
coverage profile carries signal. Full-length simulated reads (the SIRV
protocol) cannot show this — every candidate's profile looks the same.
This harness builds the case where coverage shape IS the signal:

* Isoform pairs sharing their 3' end: a short isoform S and a long
  isoform L whose last |S| bases are identical (ONT cDNA reality:
  3'-end-sharing isoforms of one gene). An alignment to the shared
  suffix is score-identical on both — the aligner cannot discriminate.
* ONT cDNA-like 3'-anchored truncation: each read starts at the polyA
  end and extends a Beta-distributed fraction of its true source; reads
  shorter than |S| map ambiguously to both isoforms, longer reads are
  unique evidence for L.
* Per-pair truth scenarios: S-only, L-only, and both-expressed.

Without the coverage model the EM splits score-tied reads by mass
alone. With it, a truly-expressed S shows near-uniform coverage while
the phantom L allocation stacks into L's 3' tail (count >> per-bin
expectation -> logistic prob ~1e-8), pushing ambiguous reads to S —
and symmetrically, a truly-expressed L is anchored by its unique long
reads. Metrics: Spearman + MARD vs true counts, with/without
--model-coverage, plus per-scenario MARD so a negative result is
analyzable rather than averaged away.

Prints one JSON line. Usage:
  python scripts/degraded_cov_eval.py [--pairs 60] [--reads 40000]
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO / "scripts"))


def simulate_degraded_bam(path, pairs, reads, seed):
    """Write a name-collated BAM of 3'-anchored truncated reads over
    S/L isoform pairs. Returns (names, lengths, true_counts,
    scenario)."""
    from oarfish_tpu.io import bam

    rng = np.random.default_rng(seed)
    P = pairs
    Ls = rng.integers(600, 2000, size=P)
    Ll = (Ls * rng.uniform(2.5, 4.0, size=P)).astype(np.int64)
    names, lengths = [], []
    for i in range(P):
        names += [f"gene{i}_S", f"gene{i}_L"]
        lengths += [int(Ls[i]), int(Ll[i])]
    T = 2 * P

    # scenario per pair: 0 = S-only, 1 = L-only, 2 = both
    scenario = rng.choice([0, 1, 2], size=P, p=[0.5, 0.25, 0.25])
    expr = np.zeros(T)
    for i, sc in enumerate(scenario):
        if sc == 0:
            expr[2 * i] = rng.uniform(0.5, 2.0)
        elif sc == 1:
            expr[2 * i + 1] = rng.uniform(0.5, 2.0)
        else:
            expr[2 * i] = rng.uniform(0.5, 2.0)
            expr[2 * i + 1] = rng.uniform(0.5, 2.0)
    expr /= expr.sum()

    src = rng.choice(T, size=reads, p=expr)
    true_counts = np.bincount(src, minlength=T).astype(float)

    records = []
    for rid in range(reads):
        t = int(src[rid])
        pair = t // 2
        is_long = t % 2 == 1
        Lt = lengths[t]
        # 3'-anchored truncation: Beta(1.6, 1.0)-distributed covered
        # fraction (median ~0.65, long right tail of near-full reads)
        frac = rng.beta(1.6, 1.0)
        rl = max(120, int(Lt * frac))
        rl = min(rl, Lt)
        span = rl
        score = 2 * span  # perfect match in the covered window
        recs = []
        # alignment to the true source, anchored at its 3' end
        pos_t = Lt - rl
        recs.append((t, pos_t, span, score, 0))
        # the shared 3' suffix maps to the partner when it fits
        Lshort = lengths[2 * pair]
        if rl <= Lshort:
            other = 2 * pair + (0 if is_long else 1)
            Lo = lengths[other]
            recs.append((other, Lo - rl, span, score,
                         bam.FLAG_SECONDARY))
        for ref, pos, sp, sc_, flag in recs:
            records.append(dict(
                name=f"read{rid}", flag=flag, ref_id=ref, pos=pos,
                cigar=f"{sp}M", seq=("A" * sp if flag == 0 else ""),
                score=sc_,
            ))
    bam.write_bam(str(path), names, lengths, records)
    return names, lengths, true_counts, scenario


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=60)
    ap.add_argument("--reads", type=int, default=40_000)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--outdir", default="/tmp/oarfish_degraded_eval")
    args = ap.parse_args()

    from eval_quant import read_quant
    from scipy.stats import spearmanr

    out = Path(args.outdir)
    out.mkdir(parents=True, exist_ok=True)
    bam_p = out / "degraded.bam"
    names, lengths, truth, scenario = simulate_degraded_bam(
        bam_p, args.pairs, args.reads, args.seed)

    results = {}
    for label, cov in (("no_cov", False), ("cov", True)):
        cmd = [sys.executable, "-m", "oarfish_tpu",
               "--alignments", str(bam_p), "-o", str(out / label),
               "--em-dtype", "float64", "--quiet"]
        if cov:
            cmd.append("--model-coverage")
        r = subprocess.run(
            cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-3000:])
            raise SystemExit(1)
        df = read_quant(out / f"{label}.quant")
        q = dict(zip(df["name"], df["count"]))
        est = np.array([float(q.get(n, 0.0)) for n in names])
        mask = truth > 0
        rel = np.abs(est - truth)[mask] / truth[mask]
        # MARD over all transcripts, eval_sim style: |e-t| / max(t,e)
        denom = np.maximum(np.maximum(truth, est), 1e-12)
        ard = np.abs(est - truth) / denom
        per_sc = {}
        for sc, nm in ((0, "S_only"), (1, "L_only"), (2, "both")):
            sel = np.repeat(scenario == sc, 2)
            per_sc[nm] = round(float(ard[sel].mean()), 4)
        results[label] = {
            "spearman": round(float(spearmanr(truth, est).statistic), 4),
            "mard": round(float(ard.mean()), 4),
            "mean_rel_err_expressed": round(float(rel.mean()), 4),
            "per_scenario_mard": per_sc,
        }

    summary = {
        "protocol": "3'-degraded isoform-pair eval (coverage-model value)",
        "pairs": args.pairs, "reads": args.reads, "seed": args.seed,
        "no_cov": results["no_cov"], "cov": results["cov"],
        "mard_improvement": round(
            results["no_cov"]["mard"] - results["cov"]["mard"], 4),
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
