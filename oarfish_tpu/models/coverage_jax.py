"""Device (JAX) coverage model: logistic per-bin probabilities +
per-read coverage normalization as segment ops over the flat bin CSR.

This is the SURVEY §7 step-4 formulation ("vectorized jnp over padded
bins", "segment gather + segment-sum over CSR") of
`src/util/logistic_probability.rs:40-79` and
`src/util/normalize_probability.rs:5-74`. The NumPy functions in
`coverage.py` (`logistic_prob_np`, `normalize_read_probs_np`) are the
differential oracle.

Deployment note: the multithreaded native pass (csrc/covmodel.cpp) is
the default in the drivers; this module is selected with
OARFISH_COVMODEL=jax. Whether it pays for the one-shot transfer of the
~14M-bin f64 flat array over PCIe is not measured yet (ROADMAP A8).

All math is f64 (matching the reference); this is a one-shot
O(bins + alignments) pass, not the EM hot loop.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from functools import partial


@partial(jax.jit, static_argnames=("growth_rate",))
def _logistic_prob_kernel(
    bins: jax.Array,        # f64 [NB] (pre-pseudo-count)
    pseudo_of_bin: jax.Array,  # f64 [NB] total_weight[t]/100 per bin
    t_of_bin: jax.Array,    # i32 [NB]
    nbins_f: jax.Array,     # f64 [T]
    *,
    growth_rate: float,
):
    T = nbins_f.shape[0]
    bins2 = bins + pseudo_of_bin
    counts64 = bins2.astype(jnp.float32).astype(jnp.float64)
    count_sum = jax.ops.segment_sum(counts64, t_of_bin, num_segments=T)
    expected = count_sum / nbins_f
    active = count_sum > 1e-8
    exp_b = expected[t_of_bin]
    diff = (exp_b - counts64) / exp_b
    v = 1.0 / (1.0 + jnp.exp(-growth_rate * diff))
    v = jnp.clip(v, 1e-8, 0.99999)
    out = jnp.where(active[t_of_bin], v, 0.0)
    return bins2, out


def logistic_prob_jax(cov, growth_rate: float) -> np.ndarray:
    """Device logistic_prob; mutates `cov.bins` by the pseudo-count
    exactly like the host paths and returns the flat f64 probability
    array (host numpy)."""
    T = len(cov.txp_len)
    t_of_bin = np.repeat(np.arange(T, dtype=np.int32), cov.nbins)
    pseudo = (cov.total_weight / 100.0)[t_of_bin]
    bins2, out = _logistic_prob_kernel(
        jnp.asarray(cov.bins), jnp.asarray(pseudo),
        jnp.asarray(t_of_bin), jnp.asarray(cov.nbins, dtype=jnp.float64),
        growth_rate=float(growth_rate),
    )
    cov.bins[:] = np.asarray(bins2)
    return np.asarray(out)


@jax.jit
def _normalize_kernel(
    cov_prob_flat: jax.Array,  # f64 [NB]
    tid: jax.Array,            # i32 [A]
    start: jax.Array,          # f64 [A]
    end: jax.Array,            # f64 [A]
    rid: jax.Array,            # i32 [A]
    bin_off: jax.Array,        # i64 [T] (per-transcript bin offset)
    nbins: jax.Array,          # i64 [T]
    lenf: jax.Array,           # f64 [T]
    bl: jax.Array,             # f64 scalar
    num_reads: jax.Array,      # i8 [R] dummy carrying the static read count
):
    nb = nbins[tid]
    sb = (start / bl).astype(jnp.int64)
    eb = jnp.minimum((end / bl).astype(jnp.int64), nb - 1)
    off = bin_off[tid]

    csum0 = jnp.concatenate(
        [jnp.zeros((1,), dtype=cov_prob_flat.dtype),
         jnp.cumsum(cov_prob_flat)]
    )
    same = sb == eb
    # single-bin: expected = cp (w != 0) else NaN
    w_same = (end - start) / bl
    cp_same = cov_prob_flat[off + sb]
    exp_same = jnp.where(w_same != 0.0, cp_same, jnp.nan)
    # multi-bin: fractional first bin + interior prefix-sum difference
    a = off + sb + 1
    b = off + eb
    n_interior = jnp.maximum((b - a).astype(jnp.float64), 0.0)
    interior = jnp.where(a < b, csum0[b] - csum0[a], 0.0)
    bin_end_first = jnp.minimum(bl * sb.astype(jnp.float64) + bl, lenf[tid])
    w_first = (bin_end_first - start) / bl
    exp_multi = (w_first * cp_same + interior) / (w_first + n_interior)

    expected = jnp.where(same, exp_same, exp_multi)
    nsum = jax.ops.segment_sum(expected, rid,
                               num_segments=num_reads.shape[0])
    denom = jnp.where(nsum > 0.0, nsum, 1.0)
    out = expected / denom[rid]
    finite = jnp.isfinite(expected).all()
    return out, finite


def normalize_read_probs_jax(store, cov, cov_prob_flat, bin_width) -> None:
    """Device normalize_read_probs; fills `store.cov_prob`."""
    A = store.num_alignments
    if A == 0:
        return
    rid = store.read_ids().astype(np.int32)
    out, finite = _normalize_kernel(
        jnp.asarray(cov_prob_flat),
        jnp.asarray(store.txp_id, dtype=jnp.int32),
        jnp.asarray(store.start, dtype=jnp.float64),
        jnp.asarray(store.end, dtype=jnp.float64),
        jnp.asarray(rid),
        jnp.asarray(cov.bin_offsets[:-1]),
        jnp.asarray(cov.nbins),
        jnp.asarray(cov.lenf),
        jnp.float64(bin_width),
        jnp.zeros((store.num_reads,), dtype=jnp.int8),
    )
    if not bool(np.asarray(finite)):
        raise FloatingPointError(
            "invalid result in normalize_read_probs (NaN/inf coverage prob)"
        )
    store.cov_prob[:] = np.asarray(out)
