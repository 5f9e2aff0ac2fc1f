"""Multi-host execution: distributed init + global CSR assembly.

The reference is strictly single-process (SURVEY §2: no collectives of any
kind); this module is new design per the north star: each host packs its
own shard of the reads (its BAM chunk), the shards are assembled into one
global device array over a `data` mesh spanning all hosts' devices, and
`sharded_em` runs with one `psum` of partial transcript counts per EM
iteration — over the devices' interconnect within a host and the
network across hosts.

On a single host this degrades to the tested N-device path; the global
assembly (`make_array_from_single_device_arrays`) is identical in both
cases, so the multi-host construction is exercised by the CPU-mesh tests.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharded_em import ShardedCsr, make_sharded_em

log = logging.getLogger("oarfish_tpu")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """`jax.distributed.initialize` wrapper; no-op when single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def global_data_mesh(devices=None) -> Mesh:
    """1-D `data` mesh over all (global) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), ("data",))


def assemble_global_shards(
    mesh: Mesh, per_device_arrays: Sequence[np.ndarray], dtype
) -> jax.Array:
    """Build a global array sharded over `data` from one equal-shaped host
    shard per local device (`jax.make_array_from_single_device_arrays`).
    In multi-host runs every process calls this with its own local
    devices' shards; the result is a global view."""
    local_devices = [d for d in mesh.devices.flat if d.process_index ==
                     jax.process_index()]
    assert len(per_device_arrays) == len(local_devices)
    shard_shape = per_device_arrays[0].shape
    global_shape = (len(list(mesh.devices.flat)) * shard_shape[0],) + tuple(
        shard_shape[1:]
    )
    sharding = NamedSharding(mesh, P("data", *([None] * (len(shard_shape) - 1))))
    singles = [
        jax.device_put(np.asarray(a, dtype=dtype), d)
        for a, d in zip(per_device_arrays, local_devices)
    ]
    return jax.make_array_from_single_device_arrays(
        global_shape, sharding, singles
    )


def allgather_hosts(x) -> np.ndarray:
    """[P, ...] stack of a host-local value across processes (identity
    stack on one process). The host-side reduction primitive for
    sharded-input runs: per-process read counts, aux-count vectors,
    discard counters."""
    x = np.asarray(x)
    if jax.process_count() == 1:
        return x[None]
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x))


def sharded_em_global_local(
    txp_id: np.ndarray,
    weights: np.ndarray,
    boundaries: np.ndarray,
    num_txps: int,
    init: np.ndarray,
    max_iter: int = 1000,
    convergence_thresh: float = 1e-3,
    dtype=jnp.float32,
    mesh: Optional[Mesh] = None,
    accel: str = "none",
    mult_local: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, int]:
    """Data-parallel EM over DISTRIBUTED INGEST: each process passes only
    ITS shard of the reads (its own BAM/FASTX chunk — the global CSR is
    the disjoint union across processes; `--alignments x.{proc}.bam`).
    The local CSR is split over this process's local devices, shard
    shapes are agreed globally (max over processes), and the same
    one-psum-per-iteration EM runs over the global mesh. `init` must be
    computed from the GLOBAL read count (callers aggregate with
    `allgather_hosts`). With `mult_local` ([B, R_local] replicate
    multiplicities over this process's reads), returns ([B, T], niters)
    bootstrap counts instead — replicates run sequentially through a
    multiplicity-capable variant of the same program."""
    if mesh is None:
        mesh = global_data_mesh()
    local_devs = [
        d for d in mesh.devices.flat
        if d.process_index == jax.process_index()
    ]
    D_local = len(local_devs)
    sh = ShardedCsr(txp_id, weights, boundaries, num_txps, D_local)
    pads = allgather_hosts(
        np.array([sh.r_pad, sh.a_pad], dtype=np.int64)
    )
    r_pad, a_pad = (int(x) for x in pads.max(axis=0))
    if (r_pad, a_pad) != (sh.r_pad, sh.a_pad):
        sh = ShardedCsr(
            txp_id, weights, boundaries, num_txps, D_local,
            r_pad=r_pad, a_pad=a_pad,
        )

    def shard_rows(arr, dt):
        return assemble_global_shards(
            mesh, [arr[d : d + 1] for d in range(D_local)], dt
        )

    gl = (
        shard_rows(sh.txp_id, jnp.int32),
        shard_rows(sh.weights, dtype),
        shard_rows(sh.read_id, jnp.int32),
        shard_rows(sh.txp_sort_perm, jnp.int32),
        shard_rows(sh.txp_id_sorted, jnp.int32),
    )
    init_p = jnp.concatenate(
        [jnp.asarray(init, dtype=dtype), jnp.zeros(1, dtype=dtype)]
    )
    conv = jnp.asarray(convergence_thresh, dtype=dtype)
    if mult_local is None:
        run = make_sharded_em(
            mesh, num_txps, r_pad, max_iter, accel=accel
        )
        counts, niter = run(*gl, init_p, conv)
        return np.asarray(counts, dtype=np.float64)[:num_txps], int(niter)

    run_m = make_sharded_em(
        mesh, num_txps, r_pad, max_iter, accel=accel, with_mult=True
    )
    mult_sh = sh.shard_multiplicity(mult_local)  # [D_local, B, r_pad]
    breps = []
    niters = []
    for b in range(mult_local.shape[0]):
        mult_g = shard_rows(
            np.ascontiguousarray(mult_sh[:, b, :]), dtype
        )
        cb, nb = run_m(*gl, init_p, conv, mult_g)
        breps.append(np.asarray(cb, dtype=np.float64)[:num_txps])
        niters.append(int(nb))
    return np.stack(breps), niters


def split_bootstrap_multiplicities(
    num_boot: int, num_reads_local: int, seed: int
) -> np.ndarray:
    """[B, R_local] bootstrap multiplicities for THIS process's reads,
    jointly distributed as one global Multinomial(R_global, uniform)
    across all processes (the reference's with-replacement sample,
    `bootstrap.rs:7-16`, over the union of all shards). Uses the
    multinomial splitting property: every process draws the SAME
    process-level totals n_p ~ Multinomial(R_global, R_p/R_global) from
    the shared seed, then its own conditional Multinomial(n_p, uniform
    over its local reads) from a process-specific stream."""
    r_locals = allgather_hosts(
        np.array([num_reads_local], dtype=np.int64)
    )[:, 0]
    r_global = int(r_locals.sum())
    pidx = jax.process_index()
    rng_shared = np.random.default_rng(seed)
    if r_global == 0:
        return np.zeros((num_boot, num_reads_local))
    per_proc = rng_shared.multinomial(
        r_global, r_locals / r_global, size=num_boot
    )  # identical on every process
    rng_local = np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(pidx + 1,))
    )
    out = np.zeros((num_boot, num_reads_local))
    if num_reads_local:
        p = np.full(num_reads_local, 1.0 / num_reads_local)
        for b in range(num_boot):
            out[b] = rng_local.multinomial(int(per_proc[b, pidx]), p)
    return out


def sharded_em_global(
    txp_id: np.ndarray,
    weights: np.ndarray,
    boundaries: np.ndarray,
    num_txps: int,
    init: np.ndarray,
    max_iter: int = 1000,
    convergence_thresh: float = 1e-3,
    dtype=jnp.float32,
    mesh: Optional[Mesh] = None,
    accel: str = "none",
) -> Tuple[np.ndarray, int]:
    """Data-parallel EM where the CSR shards are placed per device through
    the global-assembly path (multi-host capable; on one host this equals
    `sharded_em` but exercises the same construction a pod run uses)."""
    if mesh is None:
        mesh = global_data_mesh()
    D = len(list(mesh.devices.flat))
    sh = ShardedCsr(txp_id, weights, boundaries, num_txps, D)
    run = make_sharded_em(mesh, num_txps, sh.r_pad, max_iter, accel=accel)

    # only THIS process's devices are addressable in a multi-process run:
    # place the mesh positions owned by local devices (every process
    # computes the full shard set from the same CSR; the global array is
    # assembled from each process's local pieces)
    local_pos = [
        i
        for i, d in enumerate(mesh.devices.flat)
        if d.process_index == jax.process_index()
    ]

    def shard_rows(arr, dt):
        return assemble_global_shards(
            mesh, [arr[p : p + 1] for p in local_pos], dt
        )

    init_p = jnp.concatenate(
        [jnp.asarray(init, dtype=dtype), jnp.zeros(1, dtype=dtype)]
    )
    counts, niter = run(
        shard_rows(sh.txp_id, jnp.int32),
        shard_rows(sh.weights, dtype),
        shard_rows(sh.read_id, jnp.int32),
        shard_rows(sh.txp_sort_perm, jnp.int32),
        shard_rows(sh.txp_id_sorted, jnp.int32),
        init_p,
        jnp.asarray(convergence_thresh, dtype=dtype),
    )
    return np.asarray(counts, dtype=np.float64)[:num_txps], int(niter)
