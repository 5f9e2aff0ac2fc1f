"""Per-stage delta-timing of the v4 EM iteration on the default device."""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

import bench
from oarfish_tpu.constants import EM_DENOM_THRESH
from oarfish_tpu.ops.em_v4 import CAPK, EmV4Data, _row_broadcast, _row_sums

N1, N2 = 20, 120


def delta_time(make_fn, data, tag):
    try:
        f1 = jax.jit(make_fn(N1))
        f2 = jax.jit(make_fn(N2))
        d = []
        for f in (f1, f2, f1, f2):
            out = f(data)
            t0 = time.perf_counter()
            np.asarray(out)
            d.append(time.perf_counter() - t0)
        d1, d2 = min(d[0], d[2]), min(d[1], d[3])
        ms = (d2 - d1) / (N2 - N1) * 1e3
        print(f"{tag}: {ms:.2f} ms/iter  (d1={d1:.2f}s d2={d2:.2f}s)",
              flush=True)
    except Exception as e:  # noqa: BLE001
        print(f"{tag}: FAILED {type(e).__name__}: {str(e)[:160]}", flush=True)


def main():
    txp_id, w, boundaries, read_id, A = bench.make_csr()
    T = bench.T
    print(f"A={A} T={T}", flush=True)
    t0 = time.perf_counter()
    data, _order = EmV4Data.build(txp_id, w, boundaries, T)
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)

    NPAD = data.p_a.n_in
    x0 = jnp.ones(NPAD, jnp.float32)

    def pa_loop(n):
        def f(d):
            def body(i, x):
                return d.p_a(x) * 0.999
            return jax.lax.fori_loop(0, n, body, x0)[:8]
        return f

    def pb_loop(n):
        def f(d):
            def body(i, x):
                return d.p_b(x) * 0.999
            return jax.lax.fori_loop(0, n, body, x0)[:8]
        return f

    xr = jnp.ones(data.n_slots_r, jnp.float32)

    def read_math_loop(n):
        def f(d):
            def body(i, x):
                denom = _row_sums(x, d.read_shapes, d.read_starts)
                scale = jnp.where(denom > EM_DENOM_THRESH, 1.0 / denom, 0.0)
                return x * 0.999 + _row_broadcast(scale, d.read_shapes) * 1e-30
            return jax.lax.fori_loop(0, n, body, xr)[:8]
        return f

    xt = jnp.ones(data.n_slots_t, jnp.float32)

    from oarfish_tpu.ops.static_permute import LANES

    def txp_math_loop(n):
        def f(d):
            def body(i, x):
                dt = x.dtype
                small_sums = _row_sums(x, d.small_shapes, d.small_starts)
                if d.big_rows_pad:
                    g = d.big_rows_pad // LANES
                    big_rows = x[
                        d.n_slots_t - d.big_rows_pad * CAPK :
                    ].reshape(g, CAPK, LANES).sum(axis=1).reshape(-1)
                    cs = jnp.concatenate(
                        [jnp.zeros(1, dt), jnp.cumsum(big_rows)]
                    )
                    o = d.big_row_offsets
                    v = jnp.concatenate(
                        [small_sums, jnp.take(cs, o[1:]) - jnp.take(cs, o[:-1])]
                    )
                else:
                    v = small_sums
                vv = jnp.zeros(d.t_space, dt).at[: v.shape[0]].set(v)
                curr = d.t_out(vv)[: d.num_txps]
                ext = jnp.zeros(d.t_space, dt).at[: d.num_txps].set(curr)
                pr = d.t_in(ext)
                pr_small = pr[: d.row_space_s]
                pr_big = pr[d.row_space_s : d.row_space_s + d.n_big]
                parts = [_row_broadcast(pr_small, d.small_shapes)]
                if d.big_rows_pad:
                    pr_rows = jnp.take(pr_big, d.big_row_of_txp)
                    g = d.big_rows_pad // LANES
                    parts.append(
                        jnp.broadcast_to(
                            pr_rows.reshape(g, 1, LANES), (g, CAPK, LANES)
                        ).reshape(-1)
                    )
                return jnp.concatenate(parts) * 0.999
            return jax.lax.fori_loop(0, n, body, xt)[:8]
        return f

    delta_time(pa_loop, data, "P_A permute")
    delta_time(pb_loop, data, "P_B permute")
    delta_time(read_math_loop, data, "read-side row math")
    delta_time(txp_math_loop, data, "txp-side row math + tiny permutes")


if __name__ == "__main__":
    main()
