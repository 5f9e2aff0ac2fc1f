"""Profile the v4 layout BUILD (host CPU work) at the bench shape.

The layout build is host work paid once per run before the device EM
starts. This times phase 1 (_v4_layout: bucketing, flow-balanced placement, slot
maps, tile permutes) and phase 2 (_v4_finish: the two GlobalRoutes)
separately, then cProfiles the whole build.

`--platform cpu` pins the jax platform; `--profile` adds cProfile.
"""

import cProfile
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

if "--platform" in sys.argv:
    jax.config.update("jax_platforms",
                      sys.argv[sys.argv.index("--platform") + 1])

import bench  # noqa: E402
from oarfish_tpu.ops import em_v4  # noqa: E402


def main():
    txp_id, w, boundaries, read_id, A = bench.make_csr()
    print(f"shape: R={bench.R} T={bench.T} A={A}", flush=True)

    # run twice: the first pass pays first-touch page faults, library
    # load/build checks, and cold caches (observed 2-3x inflation) —
    # the warm second pass is the steady-state build cost
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        lay = em_v4._v4_layout(txp_id, w, boundaries, bench.T)
        t1 = time.perf_counter()
        data = em_v4._v4_finish(lay)
        t2 = time.perf_counter()
        print(f"{label}: _v4_layout {t1 - t0:6.1f}s   "
              f"_v4_finish {t2 - t1:6.1f}s   total {t2 - t0:6.1f}s",
              flush=True)
    print(f"geometry: n_src={data.p_a.n_src} n_dst={data.p_a.n_dst} "
          f"Q={data.p_a.Q} chunk_rows={data.p_a.chunk_rows}", flush=True)

    if "--profile" in sys.argv:
        pr = cProfile.Profile()
        pr.enable()
        lay = em_v4._v4_layout(txp_id, w, boundaries, bench.T)
        em_v4._v4_finish(lay)
        pr.disable()
        stats = pstats.Stats(pr)
        stats.sort_stats("cumulative").print_stats(35)


if __name__ == "__main__":
    main()
