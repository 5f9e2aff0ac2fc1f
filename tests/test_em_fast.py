"""Scatter-free EM formulation vs the oracle and the baseline device EM."""

import jax.numpy as jnp
import numpy as np
import pytest

from oarfish_tpu.ops.em import EmData, em
from oarfish_tpu.ops.em_fast import FastEmData, run_em_fast
from oarfish_tpu.ops.em_oracle import do_em_oracle
from test_em import random_csr


@pytest.mark.parametrize("seed,R,T,max_k", [(0, 300, 40, 8), (1, 1500, 200, 30),
                                            (2, 50, 10, 3)])
def test_fast_em_matches_oracle_f64(seed, R, T, max_k):
    rng = np.random.default_rng(seed)
    txp_id, w, boundaries, read_id, R, T = random_csr(rng, R=R, T=T, max_k=max_k)
    data, order = FastEmData.build(txp_id, w, boundaries, T, dtype=jnp.float64)
    init = jnp.full(T, R / T, dtype=jnp.float64)
    counts, niter = run_em_fast(data, init, 200, 1e-3)
    want = do_em_oracle(txp_id, w, boundaries, T, max_iter=200)
    np.testing.assert_allclose(np.asarray(counts), want, rtol=1e-9, atol=1e-9)


def test_fast_em_f32_precision():
    # many reads: the double-double prefix must hold mass to f32-level
    rng = np.random.default_rng(3)
    txp_id, w, boundaries, read_id, R, T = random_csr(rng, R=20000, T=500,
                                                      max_k=6)
    data, order = FastEmData.build(txp_id, w, boundaries, T, dtype=jnp.float32)
    init = jnp.full(T, R / T, dtype=jnp.float32)
    counts, _ = run_em_fast(data, init, 120, 1e-3)
    counts = np.asarray(counts, dtype=np.float64)
    want = do_em_oracle(txp_id, w, boundaries, T, max_iter=120)
    assert abs(counts.sum() - want.sum()) / want.sum() < 1e-5
    l1 = np.abs(counts - want).sum() / want.sum()
    assert l1 < 2e-3, l1


def test_fast_em_multiplicity():
    rng = np.random.default_rng(4)
    txp_id, w, boundaries, read_id, R, T = random_csr(rng, R=200, T=30)
    mult = rng.multinomial(R, np.full(R, 1 / R)).astype(np.float64)
    data, order = FastEmData.build(txp_id, w, boundaries, T, dtype=jnp.float64)
    init = jnp.full(T, R / T, dtype=jnp.float64)
    # multiplicity must be in relabeled read order
    counts, _ = run_em_fast(data, init, 100, 1e-3,
                            multiplicity=jnp.asarray(mult[order]))
    edata = EmData.build(txp_id, w, read_id, R, T, dtype=jnp.float64)
    from oarfish_tpu.ops.em import run_em, uniform_init

    want, _ = run_em(edata, uniform_init(edata, jnp.float64), 100, 1e-3,
                     multiplicity=jnp.asarray(mult))
    np.testing.assert_allclose(np.asarray(counts), np.asarray(want),
                               rtol=1e-9, atol=1e-9)
