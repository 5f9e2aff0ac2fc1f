"""Differential tests for the static-routing building blocks.

These run the same plain-JAX code on CPU that runs on the device: the
tile permute network, the global gather routes, and the fully-routed EM
v4 m-step — each against either the plain permutation/gather it
implements or the NumPy EM oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oarfish_tpu.constants import EM_DENOM_THRESH
from oarfish_tpu.ops.static_permute import (
    CH,
    LANES,
    BatchTilePermute,
    DeviceTilePlan,
)
from test_em import random_csr


@pytest.mark.parametrize("seed,rows", [(0, 128), (1, 256), (2, 512)])
def test_tile_plan_numpy(seed, rows):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(rows * LANES)
    plan = DeviceTilePlan.build(perm, rows)
    x = rng.normal(size=rows * LANES).astype(np.float32)
    np.testing.assert_array_equal(plan.apply_numpy(x), x[perm])


def test_batch_tile_permute_device():
    rng = np.random.default_rng(3)
    rows = 256
    perms = [rng.permutation(rows * LANES) for _ in range(3)]
    bat = BatchTilePermute.build([DeviceTilePlan.build(p, rows) for p in perms])
    x = rng.normal(size=3 * rows * LANES).astype(np.float32)
    got = np.asarray(bat(jnp.asarray(x)))
    want = np.concatenate(
        [x[i * rows * LANES : (i + 1) * rows * LANES][p]
         for i, p in enumerate(perms)]
    )
    np.testing.assert_array_equal(got, want)


def _v4_numpy_m_step(dbg, data, prev):
    """Simulate the v4 routed m-step in NumPy from the build debug dict
    (column-major bucket layout)."""
    from oarfish_tpu.ops.em_v4 import CAPK, _row_broadcast, _row_sums

    ext = np.zeros(data.t_space)
    ext[: data.num_txps] = prev
    pr = ext[dbg["perm_in"]]
    pr_small = pr[: data.row_space_s]
    pr_big = pr[data.row_space_s : data.row_space_s + data.n_big]
    parts = [_row_broadcast(pr_small, data.small_shapes, xp=np)]
    if data.big_rows_pad:
        pr_rows = pr_big[np.asarray(data.big_row_of_txp)]
        g = data.big_rows_pad // 128
        parts.append(
            np.broadcast_to(
                pr_rows.reshape(g, 1, 128), (g, CAPK, 128)
            ).reshape(-1)
        )
    prev_slots = np.concatenate(parts)
    contrib_t = prev_slots * dbg["w_txp"]
    cr_full = np.zeros(dbg["NPAD"])
    cr_full[dbg["slot_of_aln"]] = contrib_t[dbg["txp_slot_of_aln"]]
    contrib_r = cr_full[: data.n_slots_r]
    denom = _row_sums(contrib_r, data.read_shapes, data.read_starts, xp=np)
    scale = np.where(denom > EM_DENOM_THRESH,
                     1.0 / np.where(denom > 0, denom, 1.0), 0.0)
    scale_slots = _row_broadcast(scale, data.read_shapes, xp=np,
                                 starts=data.read_starts)
    inc_r = contrib_r * scale_slots
    it_full = np.zeros(dbg["NPAD"])
    it_full[dbg["txp_slot_of_aln"]] = inc_r[dbg["slot_of_aln"]]
    inc_t = it_full[: data.n_slots_t]
    small_sums = _row_sums(inc_t, data.small_shapes, data.small_starts, xp=np)
    if data.big_rows_pad:
        g = data.big_rows_pad // 128
        big_rows = inc_t[data.n_slots_t - data.big_rows_pad * CAPK :].reshape(
            g, CAPK, 128
        ).sum(axis=1).reshape(-1)
        o = np.asarray(data.big_row_offsets)
        cs = np.concatenate([[0.0], np.cumsum(big_rows)])
        v = np.concatenate([small_sums, cs[o[1:]] - cs[o[:-1]]])
    else:
        v = small_sums
    vv = np.zeros(data.t_space)
    vv[: len(v)] = v
    return vv[dbg["perm_out"]][: data.num_txps]


def test_v4_routing_simulation_vs_oracle():
    """Full v4 dual-bucket layout invariants at a non-degenerate scale,
    simulated in NumPy f64: one m-step must equal the direct EM update."""
    from oarfish_tpu.ops.em_v4 import EmV4Data

    rng = np.random.default_rng(11)
    txp_id, w, boundaries, read_id, R, T = random_csr(
        rng, R=400_000, T=3_000, max_k=6
    )
    # zipf-skew the popularity so chunked hot transcripts are covered
    txp_id = (rng.zipf(1.3, size=len(txp_id)) % T).astype(np.int32)
    data, order, dbg = EmV4Data.build(txp_id, w, boundaries, T, debug=True)
    assert data.n_big > 0, "want chunked hot transcripts covered"
    prev = rng.uniform(0.5, 2.0, size=T)
    got = _v4_numpy_m_step(dbg, data, prev)
    denom = np.zeros(R)
    pv = prev[txp_id] * w
    np.add.at(denom, read_id, pv)
    scale = np.where(denom > EM_DENOM_THRESH,
                     1.0 / np.where(denom > 0, denom, 1.0), 0.0)
    want = np.zeros(T)
    np.add.at(want, txp_id, pv * scale[read_id])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_v4_device_em_vs_oracle():
    """The jitted v4 EM against the NumPy
    oracle at a scale where the routing builds."""
    import jax.numpy as jnp

    from oarfish_tpu.ops.em_oracle import do_em_oracle
    from oarfish_tpu.ops.em_v4 import EmV4Data, make_runner

    rng = np.random.default_rng(12)
    txp_id, w, boundaries, read_id, R, T = random_csr(
        rng, R=120_000, T=2_000, max_k=4
    )
    data, order = EmV4Data.build(txp_id, w, boundaries, T)
    runner = make_runner(data)
    init = jnp.full(T, R / T, dtype=jnp.float32)
    counts, niter = runner(init, 60, 5e-3)
    want = do_em_oracle(txp_id, w, boundaries, T, max_iter=60,
                        convergence_thresh=5e-3)
    got = np.asarray(counts, dtype=np.float64)
    assert abs(got.sum() - R) / R < 1e-4
    l1 = np.abs(got - want).sum() / R
    assert l1 < 2e-3, f"L1/read {l1}"


def test_global_route_device():
    """GlobalRoute (rectangular gather network): out[out_idx] = x[in_idx]
    with zeros at every uncovered output, on the device code path."""
    from oarfish_tpu.ops.static_permute import GlobalRoute

    rng = np.random.default_rng(13)
    n = 48 * CH
    n_data = int(n * 0.8)
    out_idx = np.sort(rng.choice(n, size=n_data, replace=False))
    in_idx = rng.permutation(n)[:n_data]
    gr = GlobalRoute(out_idx, in_idx, n)
    x = rng.normal(size=n).astype(np.float32)
    got = np.asarray(gr.plan(jnp.asarray(x)))
    want = np.zeros(n, np.float32)
    want[out_idx] = x[in_idx]
    np.testing.assert_array_equal(got, want)


def test_global_route_skewed():
    """Concentrated flows (hot chunk pairs) still route exactly."""
    from oarfish_tpu.ops.static_permute import GlobalRoute

    rng = np.random.default_rng(14)
    n = 32 * CH
    # a hot pair: chunk 3 -> chunk 17 carries 8x the average flow
    hot_out = 17 * CH + rng.permutation(CH)[: CH // 8]
    hot_in = 3 * CH + rng.permutation(CH)[: CH // 8]
    rest = int(n * 0.3)
    pool_out = np.setdiff1d(np.arange(n), hot_out)
    pool_in = np.setdiff1d(np.arange(n), hot_in)
    out_idx = np.concatenate([hot_out, rng.permutation(pool_out)[:rest]])
    in_idx = np.concatenate([hot_in, rng.permutation(pool_in)[:rest]])
    gr = GlobalRoute(out_idx, in_idx, n)
    x = rng.normal(size=n).astype(np.float32)
    got = np.asarray(gr.plan(jnp.asarray(x)))
    want = np.zeros(n, np.float32)
    want[out_idx] = x[in_idx]
    np.testing.assert_array_equal(got, want)


def test_v4_batched_bootstraps_match_serial():
    """The vmapped replicate runner equals per-replicate serial runs."""
    import jax.numpy as jnp

    from oarfish_tpu.ops.em_v4 import (
        EmV4Data,
        make_runner,
        run_em_v4_batch,
    )

    rng = np.random.default_rng(15)
    txp_id, w, boundaries, read_id, R, T = random_csr(
        rng, R=120_000, T=2_000, max_k=4
    )
    data, order = EmV4Data.build(txp_id, w, boundaries, T)
    runner = make_runner(data)
    init = jnp.full(T, R / T, dtype=jnp.float32)
    B = 3
    mult_reads = rng.multinomial(R, np.full(R, 1.0 / R), size=B)
    mult = jnp.asarray(mult_reads[:, np.asarray(order)], dtype=jnp.float32)
    got, niters = run_em_v4_batch(data, init, 80, 5e-3, mult)
    for b in range(B):
        want, niter = runner(init, 80, 5e-3, multiplicity=mult[b])
        np.testing.assert_allclose(
            np.asarray(got[b]), np.asarray(want), rtol=1e-5, atol=1e-3
        )
        assert int(niters[b]) == int(niter)


@pytest.mark.parametrize("n_ch", [1, 3, 7, 13])
def test_global_route_pure_transpose_invariant(n_ch):
    """The (chunk-pad, Q) selection must make the quota exchange exactly
    transposable on both sides (n_src*Q == R1*128 == R3*128), including
    awkward odd/prime chunk counts; routing stays exact."""
    from oarfish_tpu.ops.static_permute import GlobalRoute

    rng = np.random.default_rng(100 + n_ch)
    n = n_ch * CH
    n_data = max(1, int(n * 0.6))
    out_idx = np.sort(rng.choice(n, size=n_data, replace=False))
    in_idx = rng.permutation(n)[:n_data]
    gr = GlobalRoute(out_idx, in_idx, n)
    p = gr.plan
    assert p.n_src * p.Q == p.R1 * 128
    assert p.n_dst * p.Q == p.R3 * 128
    x = rng.normal(size=n).astype(np.float32)
    got = np.asarray(p(jnp.asarray(x)))
    want = np.zeros(n, np.float32)
    want[out_idx] = x[in_idx]
    np.testing.assert_array_equal(got, want)


def test_v4_fused_middle_matches_unfused(monkeypatch):
    """The fused middle stage (route-A reduce + denominator segment
    sums + scaling + route-B expand in one per-chunk function) must agree
    with the unfused HBM-round-trip path, with and without replicate
    multiplicities."""
    import jax.numpy as jnp

    from oarfish_tpu.ops.em_v4 import EmV4Data, _m_step_v4

    rng = np.random.default_rng(16)
    txp_id, w, boundaries, read_id, R, T = random_csr(
        rng, R=150_000, T=2_500, max_k=5
    )
    data, order = EmV4Data.build(txp_id, w, boundaries, T)
    assert data.seg_id is not None, "fused middle should be available"
    prev = jnp.asarray(rng.uniform(0.5, 2.0, size=T), dtype=jnp.float32)
    mult = jnp.asarray(
        rng.multinomial(R, np.full(R, 1.0 / R))[np.asarray(order)],
        dtype=jnp.float32,
    )
    for m in (None, mult):
        monkeypatch.delenv("OARFISH_V4_NO_MIDDLE", raising=False)
        fused = np.asarray(_m_step_v4(data, prev, m))
        monkeypatch.setenv("OARFISH_V4_NO_MIDDLE", "1")
        plain = np.asarray(_m_step_v4(data, prev, m))
        np.testing.assert_allclose(fused, plain, rtol=2e-5, atol=1e-6)


def test_v4_strided_exchange_matches_transpose(monkeypatch):
    """With Q forced to whole lane tiles (OARFISH_ROUTE_Q128), the
    transpose-free strided exchange (expand_y1 -> strided middle ->
    reduce_strided) must agree with the explicit-transpose path and
    with the unfused baseline."""
    import jax.numpy as jnp

    from oarfish_tpu.ops.em_v4 import EmV4Data, _m_step_v4

    monkeypatch.setenv("OARFISH_ROUTE_Q128", "1")
    rng = np.random.default_rng(17)
    txp_id, w, boundaries, read_id, R, T = random_csr(
        rng, R=150_000, T=2_500, max_k=5
    )
    data, order = EmV4Data.build(txp_id, w, boundaries, T)
    assert data.seg_id is not None
    assert data.p_a.Q % 128 == 0
    prev = jnp.asarray(rng.uniform(0.5, 2.0, size=T), dtype=jnp.float32)
    mult = jnp.asarray(
        rng.multinomial(R, np.full(R, 1.0 / R))[np.asarray(order)],
        dtype=jnp.float32,
    )
    for m in (None, mult):
        monkeypatch.delenv("OARFISH_V4_NO_STRIDED", raising=False)
        strided = np.asarray(_m_step_v4(data, prev, m))
        monkeypatch.setenv("OARFISH_V4_NO_STRIDED", "1")
        transposed = np.asarray(_m_step_v4(data, prev, m))
        monkeypatch.setenv("OARFISH_V4_NO_MIDDLE", "1")
        plain = np.asarray(_m_step_v4(data, prev, m))
        monkeypatch.delenv("OARFISH_V4_NO_MIDDLE", raising=False)
        np.testing.assert_array_equal(strided, transposed)
        np.testing.assert_allclose(strided, plain, rtol=2e-5, atol=1e-6)


def test_global_route_rect_device():
    """Rectangular GlobalRoute (n_pad_out != n_pad): out[out_idx] =
    x[in_idx] with a dst space larger than the src space, forced
    geometry, on the device code path."""
    from oarfish_tpu.ops.static_permute import GlobalRoute, route_maxflow

    rng = np.random.default_rng(15)
    n_in, n_out = 16 * CH, 48 * CH
    n_data = int(n_in * 0.7)
    out_idx = np.sort(rng.choice(n_out, size=n_data, replace=False))
    in_idx = rng.permutation(n_in)[:n_data]
    mf = route_maxflow(out_idx, in_idx, n_in, chunk=CH, n_pad_out=n_out)
    # per-side legality: n*Q % LANES^2 == 0 for both 16 and 48 chunks
    step = LANES * LANES // np.gcd(LANES * LANES, 16)
    Q = int(-(-mf // step) * step)
    gr = GlobalRoute(out_idx, in_idx, n_in, n_pad_out=n_out,
                     force_geometry=(16, 48, Q))
    assert (gr.plan.n_src, gr.plan.n_dst) == (16, 48)
    x = rng.normal(size=n_in).astype(np.float32)
    got = np.asarray(gr.plan(jnp.asarray(x)))
    want = np.zeros(n_out, np.float32)
    want[out_idx] = x[in_idx]
    np.testing.assert_array_equal(got, want)


def test_v4_rect_geometry_em_vs_oracle():
    """The v4 EM under a FORCED rectangular route geometry (read space
    padded to more chunks than the transcript space) against the NumPy
    oracle — exercises the npad_r != npad m-step path end-to-end. The
    organic trigger (`_try_rect_rebuild`) needs multi-million-alignment
    shapes; here the geometry is forced onto a small layout."""
    import os

    import jax.numpy as jnp

    from oarfish_tpu.ops.em_oracle import do_em_oracle
    from oarfish_tpu.ops.em_v4 import (
        EmV4Data, _v4_finish, _v4_layout, make_runner,
    )
    from oarfish_tpu.ops.static_permute import route_maxflow

    rng = np.random.default_rng(16)
    txp_id, w, boundaries, read_id, R, T = random_csr(
        rng, R=30_000, T=2_000, max_k=4
    )
    os.environ["OARFISH_NO_REPAIR"] = "1"
    try:
        lay = _v4_layout(txp_id, w, boundaries, T)
    finally:
        os.environ.pop("OARFISH_NO_REPAIR", None)
    CR = 128
    CHR = CR * LANES
    n_src = -(-lay["n_slots_t"] // CHR)
    n_dst = 2 * -(-lay["n_slots_r"] // CHR) + 1  # rect + odd on purpose
    mf = route_maxflow(lay["slot_of_aln"], lay["txp_slot_of_aln"],
                       n_src * CHR, chunk=CHR, n_pad_out=n_dst * CHR)
    qs = LANES * LANES // np.gcd(LANES * LANES, np.gcd(n_src, n_dst))
    Q = int(-(-mf // qs) * qs)
    lay["rect"] = (CR, n_src, n_dst, Q)
    data = _v4_finish(lay)
    assert data.p_a.n_src == n_src and data.p_a.n_dst == n_dst
    assert n_src != n_dst
    runner = make_runner(data)
    init = jnp.full(T, R / T, dtype=jnp.float32)
    counts, niter = runner(init, 60, 5e-3)
    want = do_em_oracle(txp_id, w, boundaries, T, max_iter=60,
                        convergence_thresh=5e-3)
    got = np.asarray(counts, dtype=np.float64)
    assert abs(got.sum() - R) / R < 1e-4
    l1 = np.abs(got - want).sum() / R
    assert l1 < 2e-3, f"L1/read {l1}"


def test_build_route_pair_both_directions_exact():
    """`build_route_pair` shares one native table build (one edge
    coloring per chunk side) between a route and its reverse; both
    plans must route exactly, at square and rectangular geometries
    and at both chunk sizes (H_in = 1 and > 1)."""
    from oarfish_tpu.ops.static_permute import build_route_pair

    rng = np.random.default_rng(91)
    cases = [
        # (CR, n_src, n_dst, Q or None->auto square)
        (128, 16, 16, None),
        (256, 8, 8, None),
        (128, 8, 16, 2048),  # rectangular (requires forced geometry)
    ]
    for CR, n_src, n_dst, Q in cases:
        CHR = CR * 128
        n_in, n_out_sp = n_src * CHR, n_dst * CHR
        E = int(n_in * 0.5)
        in_idx = rng.choice(n_in, size=E, replace=False).astype(np.int64)
        out_idx = rng.choice(n_out_sp, size=E, replace=False).astype(
            np.int64
        )
        kw = {"chunk_rows": CR}
        if Q is not None:
            kw.update(n_pad_out=n_out_sp,
                      force_geometry=(n_src, n_dst, Q))
        pa, pb = build_route_pair(out_idx, in_idx, n_in, **kw)
        x = rng.standard_normal(n_in).astype(np.float32)
        want = np.zeros(n_out_sp, np.float32)
        want[out_idx] = x[in_idx]
        np.testing.assert_array_equal(np.asarray(pa(jnp.asarray(x))),
                                      want)
        y = rng.standard_normal(n_out_sp).astype(np.float32)
        wantb = np.zeros(n_in, np.float32)
        wantb[in_idx] = y[out_idx]
        np.testing.assert_array_equal(np.asarray(pb(jnp.asarray(y))),
                                      wantb)


def test_global_route_numpy_fallback_matches_native():
    """The NumPy table-build fallback (used when the native library is
    unavailable) routes identically to the native path, at both square
    and multi-group chunk geometries. Locks in the fallback per the
    repo's parity rule — every fast path differential-tested."""
    import jax
    import numpy as np

    import oarfish_tpu.ops.static_permute as sp
    from oarfish_tpu.ops.static_permute import GlobalRoute

    rng = np.random.default_rng(17)
    for n_pad, E, CR in [(1 << 16, 24000, 128), (1 << 17, 70000, 256)]:
        in_idx = rng.choice(n_pad, size=E, replace=False).astype(np.int64)
        out_idx = rng.choice(n_pad, size=E, replace=False).astype(
            np.int64
        )
        x = rng.standard_normal(n_pad).astype(np.float32)
        want = np.zeros(n_pad, np.float32)
        want[out_idx] = x[in_idx]

        gr_native = GlobalRoute(out_idx, in_idx, n_pad, chunk_rows=CR)
        y_native = np.asarray(gr_native(jax.numpy.asarray(x)))
        np.testing.assert_array_equal(y_native, want)

        orig = sp.route_tables_native
        sp.route_tables_native = lambda *a, **k: False
        try:
            gr_np = GlobalRoute(out_idx, in_idx, n_pad, chunk_rows=CR)
        finally:
            sp.route_tables_native = orig
        y_np = np.asarray(gr_np(jax.numpy.asarray(x)))
        np.testing.assert_array_equal(y_np, want)


def test_load_fresh_so_bypasses_dlopen_path_dedup(tmp_path):
    """After a rebuild replaces a .so, glibc dlopen by the SAME path
    returns the old still-mapped library; `load_fresh_so` must surface
    the new code (regression: stale prebuilt liboarfish_color.so left
    `oarfish_route_tables_pair` unresolved after a successful rebuild)."""
    import ctypes
    import subprocess

    from oarfish_tpu.ops.permute_plan import load_fresh_so

    so = tmp_path / "libdedup_probe.so"

    def build(body: str):
        src = tmp_path / "probe.c"
        src.write_text(body)
        tmp = so.with_suffix(".so.new")
        subprocess.run(
            ["g++", "-shared", "-fPIC", str(src), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
        tmp.replace(so)

    build('extern "C" int probe_v1(void) { return 1; }\n')
    old = ctypes.CDLL(str(so))
    assert hasattr(old, "probe_v1") and not hasattr(old, "probe_v2")

    build('extern "C" int probe_v1(void) { return 1; }\n'
          'extern "C" int probe_v2(void) { return 2; }\n')
    # the buggy pattern: same-path reopen may still lack probe_v2
    fresh = load_fresh_so(so)
    assert fresh is not None and hasattr(fresh, "probe_v2")
    assert fresh.probe_v2() == 2


def test_v4_inkernel_batch_matches_singles(monkeypatch):
    """`_m_step_v4_batch` (replicate axis inside the route stages,
    tables read once per program; opt-in via OARFISH_V4_BATCH_KERNELS)
    must be BIT-exact vs per-replicate `_m_step_v4` calls, including
    the sub-batch split (B=6 -> 4+2) and both with and without
    multiplicities."""
    import jax.numpy as jnp

    from oarfish_tpu.ops.em_v4 import (
        EmV4Data,
        _batch_eligible,
        _m_step_v4,
        _m_step_v4_batch,
    )

    monkeypatch.setenv("OARFISH_V4_BATCH_KERNELS", "1")
    rng = np.random.default_rng(21)
    txp_id, w, boundaries, read_id, R, T = random_csr(
        rng, R=120_000, T=2_000, max_k=4
    )
    data, order = EmV4Data.build(txp_id, w, boundaries, T)
    assert _batch_eligible(data)
    B = 6
    prev_b = jnp.asarray(
        np.abs(rng.normal(10.0, 3.0, size=(B, T))), dtype=jnp.float32
    )
    mult_reads = rng.multinomial(R, np.full(R, 1.0 / R), size=B)
    mult = jnp.asarray(mult_reads[:, np.asarray(order)],
                       dtype=jnp.float32)
    for m_b in (None, mult):
        got = np.asarray(_m_step_v4_batch(data, prev_b, m_b))
        for b in range(B):
            want = np.asarray(
                _m_step_v4(
                    data, prev_b[b], None if m_b is None else m_b[b]
                )
            )
            np.testing.assert_array_equal(got[b], want)


def test_v4_prebuild_layout_bit_identical():
    """The chunk-incremental prebuild (V4Prebuild fed per-chunk CSR
    slices, as the streaming pack does) yields a layout BIT-IDENTICAL
    to the monolithic build — slot maps, permutations, read order,
    bucket shapes."""
    from types import SimpleNamespace

    from oarfish_tpu.ops.em_v4 import EmV4Data, V4Prebuild

    rng = np.random.default_rng(23)
    txp_id, w, boundaries, read_id, R, T = random_csr(
        rng, R=400_000, T=3_000, max_k=6
    )
    txp_id = (rng.zipf(1.3, size=len(txp_id)) % T).astype(np.int32)

    pb = V4Prebuild()
    # feed in uneven chunks split at group boundaries (like the packer)
    cuts = [0, 37, 100_001, 100_002, 250_000, 399_999, R]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        alo, ahi = boundaries[lo], boundaries[hi]
        pb.observe(SimpleNamespace(
            txp_id=txp_id[alo:ahi],
            boundaries=boundaries[lo:hi + 1] - alo,
        ))
    pre = pb.finish(T)
    assert pre is not None and pre["A"] == len(txp_id) and pre["R"] == R

    d0, o0, g0 = EmV4Data.build(txp_id, w, boundaries, T, debug=True)
    d1, o1, g1 = EmV4Data.build(txp_id, w, boundaries, T, debug=True,
                                pre=pre)
    assert np.array_equal(o0, o1)
    for k in ("perm_in", "perm_out", "slot_of_aln", "txp_slot_of_aln",
              "big_txps"):
        assert np.array_equal(g0[k], g1[k]), k
    assert g0["NPAD"] == g1["NPAD"]
    assert d0.read_shapes == d1.read_shapes
    assert d0.small_shapes == d1.small_shapes
    assert np.array_equal(np.asarray(d0.w_txp), np.asarray(d1.w_txp))
    assert np.array_equal(np.asarray(d0.seg_id), np.asarray(d1.seg_id))


def test_v4_prebuild_shape_mismatch_falls_back():
    """A stale/mismatched prebuild is ignored, not trusted."""
    from types import SimpleNamespace

    from oarfish_tpu.ops.em_v4 import EmV4Data, V4Prebuild

    rng = np.random.default_rng(5)
    txp_id, w, boundaries, read_id, R, T = random_csr(
        rng, R=400_000, T=3_000, max_k=6
    )
    pb = V4Prebuild()
    pb.observe(SimpleNamespace(
        txp_id=txp_id[: boundaries[100]],
        boundaries=boundaries[:101],
    ))
    pre = pb.finish(T)  # covers only 100 reads -> mismatch
    d0, o0 = EmV4Data.build(txp_id, w, boundaries, T)
    d1, o1 = EmV4Data.build(txp_id, w, boundaries, T, pre=pre)
    assert np.array_equal(o0, o1)
    assert np.array_equal(np.asarray(d0.w_txp), np.asarray(d1.w_txp))


def test_v4_plan_cache_roundtrip(tmp_path, monkeypatch):
    """A plan-cache hit reconstructs EmV4Data bit-identically (route
    tables, slot-derived arrays, meta) with fresh weights applied, and
    distinct CSR structures get distinct keys."""
    from oarfish_tpu.ops import plan_cache
    from oarfish_tpu.ops.em_v4 import EmV4Data

    monkeypatch.setenv("OARFISH_PLAN_CACHE", "1")
    monkeypatch.setenv("OARFISH_PLAN_CACHE_DIR", str(tmp_path))

    rng = np.random.default_rng(31)
    txp_id, w, boundaries, read_id, R, T = random_csr(
        rng, R=400_000, T=3_000, max_k=6
    )
    txp_id = (rng.zipf(1.3, size=len(txp_id)) % T).astype(np.int32)

    d0, o0 = EmV4Data.build(txp_id, w, boundaries, T)
    # the store runs on a background thread — wait for the entry
    import time

    key = plan_cache.layout_key(txp_id, boundaries, T)
    for _ in range(100):
        if (tmp_path / f"{key}.plan").exists():
            break
        time.sleep(0.1)
    assert (tmp_path / f"{key}.plan").exists()

    # second build with DIFFERENT weights must hit the cache and carry
    # the new weights
    w2 = w * 2.0
    d1, o1 = EmV4Data.build(txp_id, w2, boundaries, T)
    assert np.array_equal(o0, o1)
    for f in ("p_a", "p_b", "t_in", "t_out"):
        t0 = jax.tree_util.tree_leaves(getattr(d0, f))
        t1 = jax.tree_util.tree_leaves(getattr(d1, f))
        assert len(t0) == len(t1)
        for a, b in zip(t0, t1):
            assert np.array_equal(np.asarray(a), np.asarray(b)), f
    assert np.allclose(np.asarray(d1.w_txp), 2.0 * np.asarray(d0.w_txp))
    assert d0.read_shapes == d1.read_shapes
    assert d0.t_space == d1.t_space

    # different structure -> different key
    b2 = boundaries.copy()
    key2 = plan_cache.layout_key(txp_id, b2[:-1], T)
    assert key2 != key


def test_v4_plan_prefetch(tmp_path, monkeypatch):
    """The speculative prefetch path: pointer keyed on BAM identity
    starts device reconstruction early; a matching structural key uses
    it, a stale pointer is rejected."""
    from oarfish_tpu.ops import plan_cache
    from oarfish_tpu.ops.em_v4 import EmV4Data

    monkeypatch.setenv("OARFISH_PLAN_CACHE", "1")
    monkeypatch.setenv("OARFISH_PLAN_CACHE_DIR", str(tmp_path))

    rng = np.random.default_rng(37)
    txp_id, w, boundaries, read_id, R, T = random_csr(
        rng, R=400_000, T=3_000, max_k=6
    )
    txp_id = (rng.zipf(1.3, size=len(txp_id)) % T).astype(np.int32)

    fake_bam = tmp_path / "x.bam"
    fake_bam.write_bytes(b"not really a bam")
    ptr = plan_cache.bam_pointer_key(fake_bam, "fp")
    assert plan_cache.prefetch_for_bam(fake_bam, "fp") is None  # no entry

    d0, o0 = EmV4Data.build(txp_id, w, boundaries, T, pointer_key=ptr)
    import time

    key = plan_cache.layout_key(txp_id, boundaries, T)
    for _ in range(100):
        if (tmp_path / f"{key}.plan").exists():
            break
        time.sleep(0.1)
    assert plan_cache.read_pointer(ptr) == key

    pf = plan_cache.prefetch_for_bam(fake_bam, "fp")
    assert pf is not None
    d1, o1 = EmV4Data.build(txp_id, w * 3.0, boundaries, T, prefetch=pf,
                            pointer_key=ptr)
    assert np.array_equal(o0, o1)
    assert np.allclose(np.asarray(d1.w_txp), 3.0 * np.asarray(d0.w_txp))

    # stale pointer: different CSR -> prefetch rejected, build proceeds
    pf2 = plan_cache.prefetch_for_bam(fake_bam, "fp")
    txp2 = txp_id.copy()
    txp2[0] = (txp2[0] + 1) % T
    d2, o2 = EmV4Data.build(txp2, w, boundaries, T, prefetch=pf2)
    assert d2 is not None


def test_canonical_shape_class(tmp_path, monkeypatch):
    """Sticky canonical envelopes (cross-dataset compile reuse): three
    different datasets of similar scale must produce byte-identical
    EM-loop HLO (the persistent XLA compile cache then serves the FIRST
    run of new data), and counts must still match the oracle."""
    import jax
    import jax.numpy as jnp
    import jax.tree_util as jtu

    from oarfish_tpu.ops.em_oracle import do_em_oracle
    from oarfish_tpu.ops.em_v4 import (
        EmV4Data, _run_em_v4_jit, make_runner,
    )

    monkeypatch.setenv("OARFISH_PLAN_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("OARFISH_CANONICAL_MIN", "0")

    def mk(seed, R, T):
        rng = np.random.default_rng(seed)
        sizes = rng.geometric(1 / 2.5, R).clip(1, 4)
        A = int(sizes.sum())
        b = np.zeros(R + 1, np.int64)
        np.cumsum(sizes, out=b[1:])
        t = (rng.zipf(1.3, A) % T).astype(np.int32)
        w = np.exp(rng.normal(0, 0.5, A))
        return t, w, b, T

    def hlo(d, T):
        ext = jnp.zeros(d.t_space, jnp.float32).at[:T].set(1.0)
        return jax.jit(
            lambda dd, i: _run_em_v4_jit(dd, i, 10, -1.0)
        ).lower(d, ext).as_text()

    sets = [mk(1, 60_000, 1_500), mk(7, 60_500, 1_550),
            mk(13, 59_000, 1_480)]
    # pass 1 may GROW the class monotonically (the default headroom is
    # 1.0 — tight shapes; a slightly bigger dataset costs ONE sticky
    # recompile instead of taxing every iteration, see
    # canonical_envelope). After the class has absorbed all three,
    # every rebuild must fit and share ONE byte-identical EM HLO.
    for t, w, b, T in sets:
        EmV4Data.build(t, w, b, T)
    datas = [EmV4Data.build(t, w, b, T)[0] for t, w, b, T in sets]
    h0 = hlo(datas[0], sets[0][3])
    for d, (t, w, b, T) in zip(datas[1:], sets[1:]):
        assert hlo(d, T) == h0, "EM HLO differs across the shape class"
    # shapes equal leaf-by-leaf
    s0 = [getattr(leaf, "shape", None)
          for leaf in jtu.tree_flatten(datas[0])[0]]
    for d in datas[1:]:
        s = [getattr(leaf, "shape", None)
             for leaf in jtu.tree_flatten(d)[0]]
        assert s == s0
    # correctness under the shared envelope
    t, w, b, T = sets[2]
    init = jnp.full(T, b[-1] / T, dtype=jnp.float32)
    counts, _ = make_runner(datas[2])(init, 60, 5e-3)
    want = do_em_oracle(t, w, b, T, max_iter=60, convergence_thresh=5e-3)
    l1 = np.abs(np.asarray(counts, np.float64) - want).sum() / T
    assert l1 < 2e-3
