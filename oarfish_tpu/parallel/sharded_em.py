"""Data-parallel EM over a device mesh.

The reference is single-process shared-memory (SURVEY §2: no collectives of
any kind); distribution is new, first-class design here. Reads (CSR rows)
are sharded across a 1-D `data` mesh axis; every EM iteration each device
computes partial per-transcript counts from its read shard and the shards
are merged with one `psum` over the interconnect — the convergence
decision is then replicated. The entire while-loop runs inside a single `shard_map`, so XLA
sees one program with one collective per iteration.

Bootstrap replicates ride the same kernel: a [B, R] multiplicity batch is
sharded on its read axis and vmapped inside the shard_map (replicates are
device-local; only the T-sized partial counts cross the interconnect).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import EM_DENOM_THRESH, MIN_READ_THRESH


class ShardedCsr:
    """Host-side CSR partitioner: contiguous read ranges with ~equal
    alignment counts per shard, padded to a common (A_pad, R_pad)."""

    def __init__(
        self,
        txp_id: np.ndarray,
        weights: np.ndarray,
        boundaries: np.ndarray,
        num_txps: int,
        num_shards: int,
        r_pad: int = 0,
        a_pad: int = 0,
    ):
        """`r_pad`/`a_pad` force the padded shard shape (multi-host
        runs agree on the max across processes so every process's
        shards stack into one global array)."""
        R = len(boundaries) - 1
        A = len(txp_id)
        D = num_shards
        self.num_txps = int(num_txps)
        self.num_shards = D
        self.num_reads = R
        # split reads so each shard holds a contiguous range with roughly
        # equal alignments (balanced memory + compute per device)
        targets = [(A * (d + 1)) // D for d in range(D)]
        cuts = np.searchsorted(boundaries[1:], targets, side="left") + 1
        cuts = np.concatenate([[0], np.minimum(cuts, R)])
        cuts[-1] = R
        self.read_ranges = [
            (int(cuts[d]), int(cuts[d + 1])) for d in range(D)
        ]
        r_need = max(1, max(e - s for s, e in self.read_ranges))
        a_need = max(
            1,
            max(
                int(boundaries[e] - boundaries[s])
                for s, e in self.read_ranges
            ),
        )
        assert not r_pad or r_pad >= r_need, (r_pad, r_need)
        assert not a_pad or a_pad >= a_need, (a_pad, a_need)
        r_pad = r_pad or r_need
        a_pad = a_pad or a_need
        Tslot = self.num_txps  # dummy transcript slot index
        self.r_pad, self.a_pad = r_pad, a_pad

        txp = np.full((D, a_pad), Tslot, dtype=np.int32)
        wts = np.zeros((D, a_pad), dtype=np.float64)
        rid = np.full((D, a_pad), r_pad, dtype=np.int32)
        perm = np.zeros((D, a_pad), dtype=np.int32)
        tsrt = np.full((D, a_pad), Tslot, dtype=np.int32)
        nreads = np.zeros((D,), dtype=np.int32)
        for d, (s, e) in enumerate(self.read_ranges):
            lo, hi = int(boundaries[s]), int(boundaries[e])
            a = hi - lo
            txp[d, :a] = txp_id[lo:hi]
            wts[d, :a] = weights[lo:hi]
            lens = np.diff(boundaries[s : e + 1])
            rid[d, :a] = np.repeat(
                np.arange(e - s, dtype=np.int32), lens
            )
            p = np.argsort(txp[d], kind="stable").astype(np.int32)
            perm[d] = p
            tsrt[d] = txp[d][p]
            nreads[d] = e - s
        self.txp_id = txp
        self.weights = wts
        self.read_id = rid
        self.txp_sort_perm = perm
        self.txp_id_sorted = tsrt
        self.shard_num_reads = nreads

    def shard_multiplicity(self, mult: np.ndarray) -> np.ndarray:
        """Shard a [B, R] replicate-multiplicity matrix to
        [D, B, r_pad] aligned with the read ranges."""
        B = mult.shape[0]
        out = np.zeros((self.num_shards, B, self.r_pad), dtype=mult.dtype)
        for d, (s, e) in enumerate(self.read_ranges):
            out[d, :, : e - s] = mult[:, s:e]
        return out


def make_sharded_em(
    mesh: Mesh,
    num_txps: int,
    r_pad: int,
    max_iter: int,
    min_iters: int = 50,
    accel: str = "none",
    with_mult: bool = False,
):
    """Build the pjit-compiled sharded EM. Returns a function
    (shard arrays..., init, conv_thresh) -> (counts, niter). With
    `with_mult` the function takes a trailing [D, r_pad] per-read
    multiplicity shard (bootstrap replicates over sharded reads)."""
    # communication-volume observability (multi-host efficiency case,
    # PERF_NOTES "multi-host scaling model"): the ONLY cross-device
    # traffic is the per-iteration all-reduce of the (T+1)-sized
    # partial-count vector — 1 psum/iteration, 3/cycle under SQUAREM
    import logging

    psums = 3 if accel == "squarem" else 1
    logging.getLogger("oarfish_tpu").info(
        "sharded EM collective: psum of %d f32/f64 values "
        "(%.2f MB at f32) x %d per %s over the 'data' mesh axis",
        num_txps + 1, 4.0 * (num_txps + 1) / 1e6, psums,
        "SQUAREM cycle" if psums == 3 else "EM iteration",
    )

    def m_step(prev, txp_id, weights, read_id, perm, tsorted, mult):
        contrib = prev[txp_id] * weights
        denom = jax.ops.segment_sum(
            contrib, read_id, r_pad + 1, indices_are_sorted=True
        )
        if mult is None:
            scale = jnp.where(denom > EM_DENOM_THRESH, 1.0 / denom, 0.0)
        else:
            m = jnp.concatenate([mult, jnp.zeros(1, mult.dtype)])
            scale = jnp.where(denom > EM_DENOM_THRESH, m / denom, 0.0)
        inc = contrib * scale[read_id]
        local = jax.ops.segment_sum(
            inc[perm], tsorted, num_txps + 1, indices_are_sorted=True
        )
        # merge shard-partial transcript counts across the mesh (the one
        # collective per EM iteration)
        return jax.lax.psum(local, "data")

    def em_loop(txp_id, weights, read_id, perm, tsorted, init, conv, mult):
        if accel == "squarem":
            from ..ops.em import squarem_em

            def f(prev):
                return m_step(
                    prev, txp_id, weights, read_id, perm, tsorted, mult
                )

            return squarem_em(f, init, max_iter, conv, min_iters)

        def rel_diff(prev, curr):
            mask = prev > MIN_READ_THRESH
            safe = jnp.where(mask, prev, 1.0)
            rd = jnp.where(mask, (curr - prev) / safe, -jnp.inf)
            return jnp.maximum(jnp.max(rd), 0.0)

        def cond(state):
            niter, _, converged = state
            return jnp.any((niter < max_iter) & (~converged))

        def body(state):
            niter, prev, converged = state
            curr = m_step(prev, txp_id, weights, read_id, perm, tsorted, mult)
            rd = rel_diff(prev, curr)
            newly = (rd < conv) & (niter > min_iters)
            curr = jnp.where(converged, prev, curr)
            niter = jnp.where(converged, niter, niter + 1)
            return (niter, curr, converged | newly)

        niter, prev, _ = jax.lax.while_loop(
            cond, body, (jnp.asarray(0, jnp.int32), init, jnp.asarray(False))
        )
        prev = jnp.where(prev < MIN_READ_THRESH, 0.0, prev)
        counts = m_step(prev, txp_id, weights, read_id, perm, tsorted, mult)
        return counts, niter

    if with_mult:
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                P("data", None),
                P("data", None),
                P("data", None),
                P("data", None),
                P("data", None),
                P(),
                P(),
                P("data", None),
            ),
            out_specs=(P(), P()),
        )
        def run_m(txp_id, weights, read_id, perm, tsorted, init, conv,
                  mult):
            return em_loop(
                txp_id[0], weights[0], read_id[0], perm[0], tsorted[0],
                init, conv, mult[0],
            )

        return jax.jit(run_m)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P("data", None),
            P("data", None),
            P("data", None),
            P("data", None),
            P("data", None),
            P(),
            P(),
        ),
        out_specs=(P(), P()),
    )
    def run(txp_id, weights, read_id, perm, tsorted, init, conv):
        return em_loop(
            txp_id[0], weights[0], read_id[0], perm[0], tsorted[0],
            init, conv, None,
        )

    return jax.jit(run)


def sharded_em(
    txp_id: np.ndarray,
    weights: np.ndarray,
    boundaries: np.ndarray,
    num_txps: int,
    init: np.ndarray,
    max_iter: int = 1000,
    convergence_thresh: float = 1e-3,
    dtype=jnp.float32,
    devices=None,
    num_shards: int = 0,
    accel: str = "none",
) -> Tuple[np.ndarray, int]:
    """Host entry: shard the CSR, run the mesh EM, return (counts[T], niter)."""
    if devices is None:
        devices = jax.devices()
    D = num_shards or len(devices)
    devices = devices[:D]
    mesh = Mesh(np.array(devices), ("data",))
    sh = ShardedCsr(txp_id, weights, boundaries, num_txps, D)
    run = make_sharded_em(mesh, num_txps, sh.r_pad, max_iter, accel=accel)
    init_p = jnp.concatenate(
        [jnp.asarray(init, dtype=dtype), jnp.zeros(1, dtype=dtype)]
    )
    counts, niter = run(
        jnp.asarray(sh.txp_id),
        jnp.asarray(sh.weights, dtype=dtype),
        jnp.asarray(sh.read_id),
        jnp.asarray(sh.txp_sort_perm),
        jnp.asarray(sh.txp_id_sorted),
        init_p,
        jnp.asarray(convergence_thresh, dtype=dtype),
    )
    return np.asarray(counts, dtype=np.float64)[:num_txps], int(niter)
