"""`chip_smoke.py`: its NumPy reference EM against the serial oracle, its
CPU rehearsal, its refusal to run off a GPU, and (on a GPU host) the EM
implementations against the reference on the card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from oarfish_tpu.ops.em_oracle import do_em_oracle
from test_em import random_csr

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_em_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    txp_id, w, boundaries, _read_id, R, T = random_csr(
        rng, R=400, T=60, max_k=6
    )
    mult = rng.multinomial(R, np.full(R, 1.0 / R)).astype(np.float64)
    for m in (None, mult):
        got = chip_smoke.reference_em(txp_id, w, boundaries, T,
                                      multiplicity=m)
        want = do_em_oracle(txp_id, w, boundaries, T, multiplicity=m)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def _run_smoke(args, timeout):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OARFISH_PLAN_CACHE="0")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout, env=env,
    )


def test_rehearse_runs_every_phase_on_cpu():
    r = _run_smoke(["--rehearse"], timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {"platform": "cpu",
                                           "kind": "cpu", "count": 1}}
    for phase in ("a em kernels", "b bulk cli", "c bootstraps",
                  "d single-cell"):
        assert f"phase {phase}: ok" in r.stdout
    assert "BAM decoder: native" in r.stdout


def test_refuses_to_run_without_a_gpu():
    r = _run_smoke([], timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr


@pytest.mark.gpu
def test_em_impls_on_gpu_match_reference(gpu_device):
    import jax
    import jax.numpy as jnp

    import bench

    R, T = 50_000, 2_000
    txp_id, w, boundaries, read_id, _A = bench.make_csr(R, T, seed=3)
    ref = chip_smoke.reference_em(txp_id, w, boundaries, T, max_iter=50,
                                  convergence_thresh=-1.0)
    with jax.default_device(gpu_device):
        init = jnp.full(T, R / T, dtype=jnp.float32)
        for impl in ("segsum", "fast", "v4"):
            run, _ = bench.build_em(impl, txp_id, w, boundaries, read_id,
                                    T, jnp.float32)
            counts, _ = run(init, 50, -1.0)
            mass, l1 = chip_smoke.f32_deviation(np.asarray(counts), ref)
            assert mass < chip_smoke.F32_MASS_TOL, (impl, mass)
            assert l1 < chip_smoke.F32_L1_TOL, (impl, l1)
