"""Profile the COLD v4 layout + route-table build on the e2e fixture.

CPU-only (jax pinned to cpu — device transfers inside EmV4Data.build go
to host buffers, so this isolates the host-side build cost), plan cache
and prebuild disabled. Prints the layout phase split
(OARFISH_V4_BUILD_TIMING) and wall/cpu totals.

Usage: python scripts/route_build_profile.py [--reads N] [--txps T] [--reps K]
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ["OARFISH_PLAN_CACHE"] = "0"
os.environ.setdefault("OARFISH_V4_BUILD_TIMING", "1")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=2_000_000)
    ap.add_argument("--txps", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--platform", default=None,
                    help="pin the jax platform (e.g. cpu)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import logging

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    import numpy as np  # noqa: E402

    from e2e_bench import ensure_fixture

    bam_path, info, _ = ensure_fixture(args.reads, args.txps)

    from oarfish_tpu.config import Args, resolve_filters
    from oarfish_tpu.host.packer import pack_bam_fast
    from oarfish_tpu.ops.em_v4 import EmV4Data

    a = Args(alignments=Path(bam_path), output=Path("/tmp/rb_out"))
    opts = resolve_filters(a)
    header, store, coverage, _ = pack_bam_fast(bam_path, opts, 100, threads=4)
    T = len(header.ref_names)
    w = store.as_prob.astype(np.float64)
    print(f"A={len(store.txp_id)} R={store.num_reads} T={T}", flush=True)

    for rep in range(args.reps):
        t0w = time.perf_counter()
        t0c = os.times()
        data, order = EmV4Data.build(store.txp_id, w, store.boundaries, T)
        t1c = os.times()
        cpu = (t1c.user - t0c.user) + (t1c.system - t0c.system)
        print(
            f"rep{rep}: build wall {time.perf_counter()-t0w:.2f}s "
            f"cpu {cpu:.2f}s",
            flush=True,
        )


if __name__ == "__main__":
    main()
