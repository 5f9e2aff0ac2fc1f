"""Profile the coverage-model phase (logistic_prob + normalize_read_probs)
at R=2M scale, broken into sub-steps, to guide the device/native port
(VERDICT r4 item 1). Runs entirely on host (CPU) — the phase under study
is host NumPy today.

Usage: python scripts/covmodel_profile.py [--reads 2000000]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax

from e2e_bench import ensure_fixture  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=2_000_000)
    ap.add_argument("--txps", type=int, default=200_000)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--platform", default=None,
                    help="pin the jax platform (e.g. cpu)")
    args = ap.parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    bam, info, gen_s = ensure_fixture(args.reads, args.txps, seed=0)
    print(f"fixture {bam} gen {gen_s:.1f}s {info}")

    from oarfish_tpu.config import Args, resolve_filters
    from oarfish_tpu.host.packer import pack_bam_fast
    from oarfish_tpu.models.coverage import (
        logistic_prob, logistic_prob_np,
        normalize_read_probs, normalize_read_probs_np)

    a = Args(alignments=Path(bam), output=Path("/tmp/covprof"),
             threads=args.threads, model_coverage=True)
    opts = resolve_filters(a)

    t0 = time.perf_counter()
    tm = {}
    header, store, cov, _ = pack_bam_fast(
        Path(bam), opts, threads=args.threads, bin_width=a.bin_width,
        timings=tm)
    t_pack = time.perf_counter() - t0
    print(f"pack {t_pack:.2f}s  detail={ {k: round(v,2) if isinstance(v,float) else v for k,v in tm.items()} }")
    print(f"A={store.num_alignments} R={store.num_reads} "
          f"bins={len(cov.bins)}")

    # ---- native vs NumPy-oracle timing + bit-compare ----
    bins0 = cov.bins.copy()

    t0 = time.perf_counter()
    flat_nat = logistic_prob(cov, a.growth_rate, threads=args.threads)
    t_log_nat = time.perf_counter() - t0

    t0 = time.perf_counter()
    normalize_read_probs(store, cov, flat_nat, a.bin_width,
                         threads=args.threads)
    t_norm_nat = time.perf_counter() - t0
    cp_nat = store.cov_prob.copy()
    print(f"native: logistic {t_log_nat:.3f}s + normalize "
          f"{t_norm_nat:.3f}s = {t_log_nat + t_norm_nat:.3f}s")

    cov.bins[:] = bins0
    t0 = time.perf_counter()
    flat_np = logistic_prob_np(cov, a.growth_rate)
    t_log_np = time.perf_counter() - t0
    t0 = time.perf_counter()
    normalize_read_probs_np(store, cov, flat_np, a.bin_width)
    t_norm_np = time.perf_counter() - t0
    print(f"numpy:  logistic {t_log_np:.3f}s + normalize "
          f"{t_norm_np:.3f}s = {t_log_np + t_norm_np:.3f}s")

    nb_flat = int((flat_nat != flat_np).sum())
    nb_cp = int((cp_nat != store.cov_prob).sum())
    rel = np.max(np.abs(cp_nat - store.cov_prob)
                 / np.maximum(np.abs(store.cov_prob), 1e-300))
    print(f"bit-diff: flat {nb_flat}/{len(flat_np)} bins, "
          f"cov_prob {nb_cp}/{len(cp_nat)} alns, max rel {rel:.2e}")


if __name__ == "__main__":
    main()
