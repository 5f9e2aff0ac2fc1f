"""Split GlobalRoute cost into expand-kernel / exchange-glue / reduce-kernel
at the bench A=6M shapes, on the default device.

Every loop body must depend on the carried value (loop-invariant code is
hoisted, CLAUDE.md) — each phase folds a few output elements back into
the input.
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

import bench
from oarfish_tpu.ops.em_v4 import EmV4Data
from oarfish_tpu.ops.static_permute import CH, LANES, _run_route_stage

N1, N2 = 8, 24


def delta_time(make_fn, tag):
    try:
        f1 = jax.jit(make_fn(N1))
        f2 = jax.jit(make_fn(N2))
        d = []
        for f in (f1, f2, f1, f2):
            out = f()
            t0 = time.perf_counter()
            np.asarray(out)
            d.append(time.perf_counter() - t0)
        d1, d2 = min(d[0], d[2]), min(d[1], d[3])
        ms = (d2 - d1) / (N2 - N1) * 1e3
        print(f"{tag}: {ms:.2f} ms/iter  (d1={d1:.2f}s d2={d2:.2f}s)",
              flush=True)
    except Exception as e:  # noqa: BLE001
        print(f"{tag}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)


def main():
    txp_id, w, boundaries, read_id, A = bench.make_csr()
    T = bench.T
    data, _order = EmV4Data.build(txp_id, w, boundaries, T)
    p = data.p_a
    print(f"A={A} n_src={p.n_src} Q={p.Q} R1={p.R1} R3={p.R3}", flush=True)
    n_src, n_dst, Q, R1, R3 = p.n_src, p.n_dst, p.Q, p.R1, p.R3

    x0 = jnp.ones(p.n_in, jnp.float32)
    y1_0 = jnp.ones((n_src, R1 * LANES), jnp.float32)
    zg_0 = jnp.ones((n_dst * R3, LANES), jnp.float32)

    def full_route(n):
        def f():
            def body(i, x):
                return p(x) * 0.999
            return jax.lax.fori_loop(0, n, body, x0)[:8]
        return f

    def expand_only(n):
        xe = jnp.ones(n_src * CH, jnp.float32)

        def f():
            def body(i, x):
                y = _run_route_stage(
                    x.reshape(n_src * p.chunk_rows, LANES),
                    p.s1_r1, p.s1_src, p.s1_row, p.s1_r2, None,
                    n_src, p.chunk_rows, R1, False,
                )
                return x * 0.999 + y.reshape(-1)[: x.shape[0]] * 1e-30
            return jax.lax.fori_loop(0, n, body, xe)[:8]
        return f

    def exchange_only(n):
        def f():
            def body(i, y1):
                t = y1.reshape(n_src, R1 * LANES)[:, : n_dst * Q]
                y2 = jnp.transpose(
                    t.reshape(n_src, n_dst, Q), (1, 0, 2)
                ).reshape(n_dst, n_src * Q)
                zg = jnp.zeros((n_dst, R3 * LANES), y1.dtype)
                zg = zg.at[:, : n_src * Q].set(y2)
                return y1 * 0.999 + zg.reshape(n_dst, -1)[
                    :, : R1 * LANES
                ].reshape(n_src, -1) * 1e-30
            return jax.lax.fori_loop(0, n, body, y1_0)[0, :8]
        return f

    def reduce_only(n):
        def f():
            def body(i, zg):
                y3 = _run_route_stage(
                    zg, p.s3_r1, p.s3_src, p.s3_row, p.s3_r2, p.s3_mask,
                    n_dst, R3, p.chunk_rows, True,
                )
                upd = jnp.zeros_like(zg).at[: y3.shape[0]].set(y3 * 1e-30)
                return zg * 0.999 + upd
            return jax.lax.fori_loop(0, n, body, zg_0)[0, :8]
        return f

    delta_time(full_route, "full p_a route")
    delta_time(expand_only, "expand kernel")
    delta_time(exchange_only, "exchange glue (slice+T+pad)")
    delta_time(reduce_only, "reduce kernel")


if __name__ == "__main__":
    main()
