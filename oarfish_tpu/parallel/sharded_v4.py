"""Read-sharded data-parallel **v4** EM over a device mesh.

`parallel/sharded_em.py` distributes the naive segment-sum m-step; this
module distributes the flagship dual-bucketed static-routed iteration
(`ops/em_v4.py`) instead, so each device runs the routed iteration and
the only cross-device traffic is the per-iteration `psum` of the T-sized
partial transcript counts (the reference is single-process shared-memory
— SURVEY §2: no collectives of any kind; distribution is new design
here).

`shard_map` requires one program for every mesh position, so all
per-shard `EmV4Data` pytrees must have IDENTICAL static metadata. That
is arranged by building every shard inside a common **envelope** (merged
bucket shapes / big-transcript rows / t-space, `ops.em_v4
.compute_envelope` + `merge_envelopes`) and forcing a common route
**geometry** (chunk-pad, Q) taken from the max per-chunk flow across
shards (`ops.static_permute.route_maxflow` / `select_route_geometry`).
Shards whose data does not fill the envelope carry dead all-zero slots —
inert through every row sum and route.

Per-shard routing arrays travel as `shard_map` data (leading mesh axis),
so each device holds only its own shard's plans: total routing metadata
across the mesh stays ~equal to the single-device build.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import MIN_READ_THRESH
from ..ops.em_v4 import (
    EmV4Data,
    _m_step_v4,
    _m_step_v4_b,
    _v4_finish,
    _v4_layout,
    compute_envelope,
    merge_envelopes,
)
from ..ops.em_fast import _rel_diff
from ..ops.static_permute import route_maxflow, select_route_geometry


def _read_cuts(boundaries: np.ndarray, num_shards: int) -> np.ndarray:
    """Contiguous read ranges with ~equal alignment counts per shard."""
    R = len(boundaries) - 1
    A = int(boundaries[-1])
    D = num_shards
    targets = [(A * (d + 1)) // D for d in range(D)]
    cuts = np.searchsorted(boundaries[1:], targets, side="left") + 1
    cuts = np.concatenate([[0], np.minimum(cuts, R)])
    cuts[-1] = R
    return cuts


class ShardedV4:
    """Host-side builder: per-shard enveloped v4 states stacked into one
    pytree with a leading shard axis."""

    def __init__(
        self,
        txp_id: np.ndarray,
        weights: np.ndarray,
        boundaries: np.ndarray,
        num_txps: int,
        num_shards: int,
    ):
        txp_id = np.asarray(txp_id)
        weights = np.asarray(weights)
        boundaries = np.asarray(boundaries, dtype=np.int64)
        D = int(num_shards)
        self.num_shards = D
        self.num_txps = int(num_txps)
        self.num_reads = len(boundaries) - 1
        cuts = _read_cuts(boundaries, D)
        self.read_ranges = [
            (int(cuts[d]), int(cuts[d + 1])) for d in range(D)
        ]

        def shard_csr(d):
            s, e = self.read_ranges[d]
            lo, hi = int(boundaries[s]), int(boundaries[e])
            return (
                txp_id[lo:hi],
                weights[lo:hi],
                boundaries[s : e + 1] - lo,
            )

        env = merge_envelopes(
            [compute_envelope(shard_csr(d)[0], shard_csr(d)[2], num_txps)
             for d in range(D)]
        )
        lays = [
            _v4_layout(*shard_csr(d), num_txps, envelope=env)
            for d in range(D)
        ]
        npads = {lay["NPAD"] for lay in lays}
        assert len(npads) == 1, f"enveloped NPADs diverged: {npads}"
        NPAD = npads.pop()
        from ..ops.em_v4 import _CR_CANDIDATES, route_config
        from ..ops.static_permute import LANES

        # per-chunk-size maxflows, maxed over shards, then one shared
        # (chunk_rows, npad, (npd, Q)) route config for every shard
        mfs = {}
        for CR in _CR_CANDIDATES:
            CHR = CR * LANES
            npad_r = ((NPAD + CHR - 1) // CHR) * CHR
            mfs[CR] = max(
                route_maxflow(
                    lay["slot_of_aln"], lay["txp_slot_of_aln"], npad_r,
                    chunk=CHR,
                )
                for lay in lays
            )
        geometry = route_config(mfs, NPAD)
        import dataclasses

        # num_reads is informational-only in EmV4Data; shard_map needs
        # identical static metadata, so carry the global count instead
        datas = [
            dataclasses.replace(
                _v4_finish(lay, geometry), num_reads=self.num_reads
            )
            for lay in lays
        ]
        # identical static metadata is the stacking precondition
        meta0 = jax.tree_util.tree_structure(datas[0])
        for dd in datas[1:]:
            assert jax.tree_util.tree_structure(dd) == meta0, (
                "per-shard v4 states diverged despite the envelope"
            )
        self.data = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *datas
        )
        self.row_space_r = datas[0].row_space_r
        self.read_orders = [lay["read_order"] for lay in lays]

    def shard_multiplicity(self, mult: np.ndarray) -> np.ndarray:
        """Map a [R] global per-read multiplicity vector to the
        [D, row_space_r] per-shard row layouts (pad rows take read 0's
        multiplicity — inert, their slots are all-zero)."""
        out = np.zeros(
            (self.num_shards, self.row_space_r), dtype=mult.dtype
        )
        for d, (s, e) in enumerate(self.read_ranges):
            out[d] = mult[s:e][self.read_orders[d]]
        return out

    def shard_multiplicity_batch(self, mult: np.ndarray) -> np.ndarray:
        """[B, R] replicate multiplicities -> [D, B, row_space_r]."""
        B = mult.shape[0]
        out = np.zeros(
            (self.num_shards, B, self.row_space_r), dtype=mult.dtype
        )
        for d, (s, e) in enumerate(self.read_ranges):
            out[d] = mult[:, s:e][:, self.read_orders[d]]
        return out


def make_sharded_v4_runner(mesh: Mesh, max_iter: int, min_iters: int = 50,
                           accel: str = "none"):
    """Jitted shard_map EM: (stacked data, init[T], conv, mult|None) ->
    (counts[T], niter); one psum per iteration (three per SQUAREM
    cycle with `accel="squarem"` — the extrapolation itself works on
    the replicated T-vector, so no extra collectives)."""

    def em_local(data, init, conv, mult):
        def m_step(prev):
            local = _m_step_v4(data, prev, mult)
            return jax.lax.psum(local, "data")

        if accel == "squarem":
            from ..ops.em import squarem_em

            return squarem_em(m_step, init, max_iter, conv, min_iters)

        def cond(state):
            niter, _prev, converged = state
            return jnp.any((niter < max_iter) & (~converged))

        def body(state):
            niter, prev, converged = state
            curr = m_step(prev)
            rd = _rel_diff(prev, curr)
            newly = (rd < conv) & (niter > min_iters)
            curr = jnp.where(converged, prev, curr)
            niter = jnp.where(converged, niter, niter + 1)
            return (niter, curr, converged | newly)

        niter, prev, _ = jax.lax.while_loop(
            cond, body,
            (jnp.asarray(0, jnp.int32), init, jnp.asarray(False)),
        )
        prev = jnp.where(prev < MIN_READ_THRESH, 0.0, prev)
        counts = m_step(prev)
        return counts, niter

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("data"), P(), P(), P("data")),
        out_specs=(P(), P()),
    )
    def run(data_shard, init, conv, mult_shard):
        data_local = jax.tree_util.tree_map(lambda x: x[0], data_shard)
        mult = None if mult_shard is None else mult_shard[0]
        return em_local(data_local, init, conv, mult)

    return jax.jit(run)


def make_sharded_v4_batch_runner(
    mesh: Mesh, max_iter: int, min_iters: int = 50, accel: str = "none"
):
    """Batched bootstrap-replicate EMs over the mesh: every shard runs
    all B replicates vmapped through its routed m-step (the static
    routing arrays are shared across replicates, so per-index work
    amortizes — PERF_NOTES "vmap amortization"), with ONE psum of the
    [B, T] partial counts per iteration and per-replicate convergence
    freezing (serial-loop semantics per replicate, `em.rs:144-255`)."""

    def em_local(data, init, conv, mult_b):
        B = mult_b.shape[0]
        init_b = jnp.broadcast_to(init, (B,) + init.shape)

        def m_step_b(prev_b):
            local = _m_step_v4_b(data, prev_b, mult_b)
            return jax.lax.psum(local, "data")

        if accel == "squarem":
            from ..ops.em import squarem_em

            return squarem_em(
                m_step_b, init_b, max_iter, conv, min_iters,
                batched=True,
            )

        def cond(state):
            niter, _prev, convg = state
            return jnp.any((niter < max_iter) & (~convg))

        def body(state):
            niter, prev, convg = state
            curr = m_step_b(prev)
            rd = jax.vmap(_rel_diff)(prev, curr)
            newly = (rd < conv) & (niter > min_iters)
            curr = jnp.where(convg[:, None], prev, curr)
            niter = jnp.where(convg, niter, niter + 1)
            return (niter, curr, convg | newly)

        niter, prev, _ = jax.lax.while_loop(
            cond, body,
            (jnp.zeros(B, jnp.int32), init_b, jnp.zeros(B, bool)),
        )
        prev = jnp.where(prev < MIN_READ_THRESH, 0.0, prev)
        counts = m_step_b(prev)
        return counts, niter

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("data"), P(), P(), P("data")),
        out_specs=(P(), P()),
    )
    def run(data_shard, init, conv, mult_shard):
        data_local = jax.tree_util.tree_map(lambda x: x[0], data_shard)
        return em_local(data_local, init, conv, mult_shard[0])

    return jax.jit(run)


def sharded_v4_bootstrap(
    sh: "ShardedV4",
    mesh: Mesh,
    init: np.ndarray,
    mult: np.ndarray,
    max_iter: int = 1000,
    convergence_thresh: float = 1e-3,
    dtype=jnp.float32,
    batch: int = 8,
    accel: str = "none",
) -> np.ndarray:
    """Run all replicates of `mult` ([n_boot, R]) through the mesh in
    vmapped batches of `batch` (the last batch padded by repetition so
    one compilation serves all); returns [n_boot, T] f64 counts."""
    n_boot = mult.shape[0]
    BB = min(batch, n_boot)
    runner = make_sharded_v4_batch_runner(mesh, max_iter, accel=accel)
    init_j = jnp.asarray(init, dtype=dtype)
    conv_j = jnp.asarray(convergence_thresh, dtype=dtype)
    out = []
    b0 = 0
    while b0 < n_boot:
        idx = np.minimum(np.arange(b0, b0 + BB), n_boot - 1)
        mb = sh.shard_multiplicity_batch(mult[idx])
        cb, _ = runner(sh.data, init_j, conv_j, jnp.asarray(mb, dtype))
        take = min(BB, n_boot - b0)
        out.extend(np.asarray(cb[:take], dtype=np.float64))
        b0 += BB
    return np.stack(out)


def build_sharded_v4(
    txp_id: np.ndarray,
    weights: np.ndarray,
    boundaries: np.ndarray,
    num_txps: int,
    devices=None,
    num_shards: int = 0,
) -> Tuple[ShardedV4, Mesh]:
    """Envelope-build the per-shard v4 states and the device mesh (the
    expensive host step, reusable across the point EM and bootstrap
    batches)."""
    if devices is None:
        devices = jax.devices()
    D = num_shards or len(devices)
    devices = devices[:D]
    mesh = Mesh(np.array(devices), ("data",))
    sh = ShardedV4(txp_id, weights, boundaries, num_txps, D)
    # communication-volume observability (multi-host efficiency case):
    # the routed per-shard m-step is collective-free; the only traffic
    # is the per-iteration T-vector psum
    import logging

    logging.getLogger("oarfish_tpu").info(
        "sharded v4 collective: 1 psum of %d values (%.2f MB f32) per "
        "EM iteration over %d shards",
        num_txps, 4.0 * num_txps / 1e6, D,
    )
    return sh, mesh


def sharded_v4_em(
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
    multiplicity: Optional[np.ndarray] = None,
    accel: str = "none",
) -> Tuple[np.ndarray, int]:
    """Host entry: envelope-build the shards, run the mesh EM, return
    (counts[T] f64, niter). Raises ValueError where v4 routing is
    degenerate (callers fall back to the segment-sum sharded EM)."""
    sh, mesh = build_sharded_v4(
        txp_id, weights, boundaries, num_txps,
        devices=devices, num_shards=num_shards,
    )
    run = make_sharded_v4_runner(mesh, max_iter, accel=accel)
    mult = (
        None
        if multiplicity is None
        else jnp.asarray(sh.shard_multiplicity(multiplicity), dtype=dtype)
    )
    counts, niter = run(
        sh.data,
        jnp.asarray(init, dtype=dtype),
        jnp.asarray(convergence_thresh, dtype=dtype),
        mult,
    )
    return np.asarray(counts, dtype=np.float64), int(niter)
