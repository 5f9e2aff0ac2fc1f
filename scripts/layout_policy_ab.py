"""A/B the v4 layout policies on one fixture in ONE process, alternating
configs so shared-host load hits both equally. Prints per-config build
wall medians and the selected route geometry (npd, Q) — the EM-cost side
of the tradeoff.

Usage: python scripts/layout_policy_ab.py [--reads N] [--txps T] [--reps K]
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ["OARFISH_PLAN_CACHE"] = "0"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=5_000_000)
    ap.add_argument("--txps", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--platform", default=None,
                    help="pin the jax platform (e.g. cpu)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import numpy as np

    from e2e_bench import ensure_fixture

    bam_path, info, _ = ensure_fixture(args.reads, args.txps)

    from oarfish_tpu.config import Args, resolve_filters
    from oarfish_tpu.host.packer import pack_bam_fast
    from oarfish_tpu.ops import em_v4

    a = Args(alignments=Path(bam_path), output=Path("/tmp/rb_out"))
    opts = resolve_filters(a)
    header, store, coverage, _ = pack_bam_fast(
        bam_path, opts, 100, threads=4
    )
    T = len(header.ref_names)
    w = store.as_prob.astype(np.float64)
    print(f"A={len(store.txp_id)} R={store.num_reads} T={T}", flush=True)

    configs = {
        "balanced": {},
        "fast": {"OARFISH_V4_NO_BALANCE": "1", "OARFISH_NO_REPAIR": "1"},
    }
    walls = {k: [] for k in configs}
    geos = {}
    for rep in range(args.reps):
        for name, env in configs.items():
            for k in ("OARFISH_V4_NO_BALANCE", "OARFISH_NO_REPAIR"):
                os.environ.pop(k, None)
            os.environ.update(env)
            t0 = time.perf_counter()
            lay = em_v4._v4_layout(store.txp_id, w, store.boundaries, T)
            CR, NPAD, geo = (
                em_v4.route_config({lay["route_sel"][0]:
                                    lay["route_sel"][1]}, lay["NPAD"])
                if lay.get("route_sel")
                else em_v4.route_config(lay, lay["NPAD"])
            )
            data = em_v4._v4_finish(lay, (CR, NPAD, geo))
            dt = time.perf_counter() - t0
            walls[name].append(dt)
            geos[name] = (CR, NPAD // (CR * 128), geo)
            print(f"rep{rep} {name}: {dt:.2f}s geo CR={CR} "
                  f"chunks={NPAD // (CR * 128)} (npd,Q)={geo}",
                  flush=True)
            del lay, data
    for name in configs:
        ws = sorted(walls[name])
        print(f"{name}: median {ws[len(ws)//2]:.2f}s  all="
              f"{[f'{x:.2f}' for x in ws]}  geo={geos[name]}")


if __name__ == "__main__":
    main()
