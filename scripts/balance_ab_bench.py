"""A/B the flow-balanced v4 layout against random placement in ONE
process at the bench shape (cross-process comparisons mix in
run-to-run variance). Both layouts are built up-front, then
timed back-to-back with 100-iter fori_loop deltas."""

import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

import bench
from oarfish_tpu.ops.em_v4 import EmV4Data, _m_step_v4

N1, N2 = 20, 120


def time_variant(data, init, label):
    def make(n):
        def f(d):
            def body(i, prev):
                return _m_step_v4(d, prev, None) * 0.5 + prev * 0.5
            return jax.lax.fori_loop(0, n, body, init)
        return f

    f1, f2 = jax.jit(make(N1)), jax.jit(make(N2))
    d = []
    for f in (f1, f2, f1, f2):
        out = f(data)
        t0 = time.perf_counter()
        np.asarray(out)
        d.append(time.perf_counter() - t0)
    d1, d2 = min(d[0], d[2]), min(d[1], d[3])
    ms = (d2 - d1) / (N2 - N1) * 1e3
    print(f"{label}: {ms:.2f} ms/iter (d1={d1:.2f} d2={d2:.2f})",
          flush=True)
    return ms


def main():
    txp_id, w, boundaries, read_id, A = bench.make_csr()
    T = bench.T
    datas = {}
    for tag, env in (("balanced", "0"), ("random", "1")):
        os.environ["OARFISH_V4_NO_BALANCE"] = env
        t0 = time.perf_counter()
        data, _ = EmV4Data.build(txp_id, w, boundaries, T)
        print(
            f"{tag}: build {time.perf_counter() - t0:.0f}s "
            f"CR={data.p_a.chunk_rows} Q={data.p_a.Q} "
            f"n={data.p_a.n_src} R1={data.p_a.R1}",
            flush=True,
        )
        datas[tag] = data
    init = jnp.full(T, 10.0, dtype=jnp.float32)
    res = {}
    for rep in range(2):
        for tag, data in datas.items():
            ms = time_variant(datas[tag], init, f"{tag} (rep {rep})")
            res.setdefault(tag, []).append(ms)
    for tag, vals in res.items():
        print(f"{tag}: best {min(vals):.2f} ms/iter")


if __name__ == "__main__":
    main()
