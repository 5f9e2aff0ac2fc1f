"""Delta-timed v4 EM iteration on the default device at the bench shape."""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

import bench
from oarfish_tpu.ops.em_v4 import EmV4Data, _m_step_v4

N1, N2 = 20, 120  # >=100-iter delta: 16-iter deltas are noise at ms scale


def main():
    txp_id, w, boundaries, read_id, A = bench.make_csr()
    T = bench.T
    print(f"A={A} T={T}", flush=True)
    t0 = time.perf_counter()
    data, _order = EmV4Data.build(txp_id, w, boundaries, T)
    print(f"build: {time.perf_counter() - t0:.1f}s  "
          f"n_slots_r={data.n_slots_r} n_slots_t={data.n_slots_t} "
          f"PA(Q={data.p_a.Q},R1={data.p_a.R1}) "
          f"PB(Q={data.p_b.Q},R1={data.p_b.R1}) "
          f"t_space={data.t_space} n_big={data.n_big}", flush=True)
    init = jnp.full(T, 10.0, dtype=jnp.float32)

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
        res = np.asarray(out)
        d.append(time.perf_counter() - t0)
    d1, d2 = min(d[0], d[2]), min(d[1], d[3])
    print(f"v4 m-step: {(d2 - d1) / (N2 - N1) * 1e3:.2f} ms/iter "
          f"(d1={d1:.2f}s d2={d2:.2f}s) mass={res.sum():.1f}", flush=True)


if __name__ == "__main__":
    main()
