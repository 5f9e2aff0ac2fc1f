"""Dense one-hot matmul EM (`ops/em_dense.py`) vs the sparse segsum EM.

The dense formulation must reproduce the segsum path's per-cell EM
(`run_em` protocol) exactly in f64 (same fixed point, same iteration
counts, same freezing), since both implement `em.rs:144-255`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from oarfish_tpu.ops.em import EmData, run_em
from oarfish_tpu.ops.em_dense import (
    DenseCellEm,
    _m_step_dense,
    run_em_dense,
    run_em_dense_squarem,
)


def _ceil_pow2(x):
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def make_cells(rng, n_cells, t_global=64):
    cells = []
    for _ in range(n_cells):
        r_c = int(rng.integers(3, 40))
        sizes = rng.geometric(0.5, size=r_c).clip(1, 8)
        a_c = int(sizes.sum())
        txp = rng.integers(0, t_global, size=a_c).astype(np.int32)
        w = np.exp(rng.normal(0, 0.5, size=a_c))
        rid = np.repeat(np.arange(r_c, dtype=np.int32), sizes)
        cells.append((txp, w, rid, r_c))
    return cells


def pack_both(cells):
    """Pack one bucket both ways: dense (S/R) and segsum (sentinel
    slots, like CellBatch.run)."""
    a_p = _ceil_pow2(max(len(c[0]) for c in cells))
    r_p = _ceil_pow2(max(c[3] for c in cells))
    t_p = _ceil_pow2(max(int(c[0].max()) + 1 for c in cells))
    B = len(cells)

    dense = DenseCellEm.build(
        [c[0] for c in cells], [c[1] for c in cells],
        [c[2] for c in cells], a_p, r_p, t_p, dtype=jnp.float64,
    )

    txp = np.full((B, a_p), t_p, dtype=np.int32)
    wts = np.zeros((B, a_p), dtype=np.float64)
    rid = np.full((B, a_p), r_p, dtype=np.int32)
    perm = np.zeros((B, a_p), dtype=np.int32)
    tsrt = np.full((B, a_p), t_p, dtype=np.int32)
    for i, (t, w, r, _rc) in enumerate(cells):
        a = len(t)
        txp[i, :a] = t
        wts[i, :a] = w
        rid[i, :a] = r
        p = np.argsort(txp[i], kind="stable").astype(np.int32)
        perm[i], tsrt[i] = p, txp[i][p]
    seg = EmData(
        txp_id=jnp.asarray(txp), weights=jnp.asarray(wts),
        read_id=jnp.asarray(rid), txp_sort_perm=jnp.asarray(perm),
        txp_id_sorted=jnp.asarray(tsrt),
        num_reads=r_p + 1, num_txps=t_p + 1,
    )
    init = np.stack([np.full(t_p, c[3] / 64.0) for c in cells])
    return dense, seg, jnp.asarray(init), t_p


def test_m_step_dense_matches_segsum():
    rng = np.random.default_rng(3)
    cells = make_cells(rng, 7)
    dense, seg, init, t_p = pack_both(cells)
    from oarfish_tpu.ops.em import _m_step

    got = _m_step_dense(dense, init)
    # segsum uses a t_p+1 sentinel; compare the real t_p slots
    init_s = jnp.pad(init, ((0, 0), (0, 1)))
    want = jax.vmap(lambda d, p: _m_step(d, p, None))(seg, init_s)[:, :t_p]
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-12, atol=1e-12
    )


@pytest.mark.parametrize("thresh", [1e-3, 5e-2])
def test_run_em_dense_matches_run_em(thresh):
    rng = np.random.default_rng(11)
    cells = make_cells(rng, 9)
    dense, seg, init, t_p = pack_both(cells)
    got, niter_d = run_em_dense(dense, init, 400, thresh)
    init_s = jnp.pad(init, ((0, 0), (0, 1)))
    want, niter_s = jax.vmap(
        lambda d, i0: run_em(d, i0, 400, thresh)
    )(seg, init_s)
    np.testing.assert_array_equal(np.asarray(niter_d), np.asarray(niter_s))
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want)[:, :t_p], rtol=1e-9, atol=1e-9
    )
    if thresh < 1e-2:
        # per-cell freezing really happened (iteration counts differ)
        assert len(set(np.asarray(niter_d).tolist())) > 1


def test_run_em_dense_squarem_same_fixed_point():
    rng = np.random.default_rng(5)
    cells = make_cells(rng, 5)
    dense, _seg, init, _t_p = pack_both(cells)
    plain, _ = run_em_dense(dense, init, 1000, 1e-8)
    acc, _ = run_em_dense_squarem(dense, init, 1000, 1e-8)
    # same fixed point up to flat-ridge wander (random multimapping
    # cells have near-degenerate ridges; see PERF_NOTES on SQUAREM)
    np.testing.assert_allclose(
        np.asarray(plain), np.asarray(acc), atol=0.25
    )
    np.testing.assert_allclose(
        np.asarray(plain).sum(axis=1), np.asarray(acc).sum(axis=1),
        rtol=1e-6,
    )


BARCODES = ["ACGTACGT", "CCCCAAAA", "GGGGTTTT", "TTTTCCCC", "AAAACCCC"]


def test_coarsen_buckets_bounds_shapes_and_keeps_cells():
    from oarfish_tpu.quant.single_cell import (
        CellBatch,
        _ceil_pow2,
        coarsen_buckets,
    )

    rng = np.random.default_rng(2)
    cells = make_cells(rng, 120, t_global=64)
    buckets = {}
    for i, (txp, w, rid, r_c) in enumerate(cells):
        key = (_ceil_pow2(len(txp)), _ceil_pow2(r_c),
               _ceil_pow2(int(txp.max()) + 1))
        b = buckets.get(key)
        if b is None:
            b = buckets[key] = CellBatch(*key, 64)
        b.add(i, txp, w, rid, r_c, np.unique(txp))
    n_raw = len(buckets)
    out = coarsen_buckets(dict(buckets), max_buckets=4)
    assert len(out) <= min(4, n_raw)
    # every cell survives, in a bucket that fits it
    seen = {}
    for key, b in out.items():
        for i, ci in enumerate(b.cell_index):
            seen[ci] = (key, len(b.txp_local[i]))
            a, r, t = key
            assert len(b.txp_local[i]) <= a
            assert b.num_reads[i] <= r
            assert int(b.txp_local[i].max()) < t
    assert sorted(seen) == list(range(120))


def _read_mtx_text(path):
    out = {}
    lines = path.read_text().splitlines()
    for line in lines[2:]:
        r, c, v = line.split()
        out[(int(r), int(c))] = float(v)
    return out


@pytest.mark.parametrize("shards", ["1", "8"])
def test_quant_path_dense_matches_segsum(monkeypatch, tmp_path, shards):
    """End-to-end single-cell quant: OARFISH_SC_IMPL=dense vs =segsum
    produce the same count matrix (f64, incl. the sharded cells mesh)."""
    import sys

    sys.path.insert(0, str((__import__("pathlib").Path(__file__)).parent))
    from util_sim import simulate_bam

    from oarfish_tpu.cli import main

    bam = tmp_path / "sc.bam"
    simulate_bam(bam, num_reads=300, seed=9, barcodes=BARCODES)

    mats = {}
    for impl in ("segsum", "dense"):
        monkeypatch.setenv("OARFISH_SC_IMPL", impl)
        out = tmp_path / f"out_{impl}" / "sc"
        rc = main([
            "--alignments", str(bam), "--single-cell", "-o", str(out),
            "--em-dtype", "float64", "--num-shards", shards, "--quiet",
        ])
        assert rc == 0
        mats[impl] = _read_mtx_text(
            out.parent / (out.name + ".count.mtx")
        )
    a, b = mats["segsum"], mats["dense"]
    assert set(a) == set(b)
    for k in a:
        assert abs(a[k] - b[k]) <= 1e-6 * max(1.0, abs(a[k])), k


def test_quant_path_dense_sub_batched_identical(monkeypatch, tmp_path):
    """A tiny dense budget forces multi-sub-batch buckets (bounded
    memory at production cell counts); the count matrix must be
    IDENTICAL to the unbatched dense run — sub-batching only regroups
    independent cells."""
    import sys

    sys.path.insert(0, str((__import__("pathlib").Path(__file__)).parent))
    from util_sim import simulate_bam

    from oarfish_tpu.cli import main

    bam = tmp_path / "sc.bam"
    simulate_bam(bam, num_reads=300, seed=9, barcodes=BARCODES)
    monkeypatch.setenv("OARFISH_SC_IMPL", "dense")

    mats = {}
    for label, budget in (("one", None), ("sub", "0")):
        if budget is None:
            monkeypatch.delenv("OARFISH_SC_DENSE_BUDGET_MB", raising=False)
        else:
            # zero budget -> sub == 1: every cell runs as its own batch
            monkeypatch.setenv("OARFISH_SC_DENSE_BUDGET_MB", budget)
        out = tmp_path / f"out_{label}" / "sc"
        rc = main([
            "--alignments", str(bam), "--single-cell", "-o", str(out),
            "--em-dtype", "float64", "--quiet",
        ])
        assert rc == 0
        mats[label] = _read_mtx_text(out.parent / (out.name + ".count.mtx"))
    assert mats["one"] == mats["sub"]
