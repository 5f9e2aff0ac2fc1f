"""Multi-host scaling-efficiency model (BASELINE: >=0.8 @ 4 hosts).

No multi-host hardware is available to this script, so the case is
assembled from three pieces:

  (a) EXACT per-iteration communication volume. The sharded EMs'
      only collective is one psum of the (T)-sized f32 partial-count
      vector per iteration (3 per SQUAREM cycle). No alignment-space
      data ever crosses a device boundary.
  (b) A measured compute-vs-collective split on a virtual 8-device
      mesh (shape of the program, not device time): the same shard_map
      program with the psum replaced by the local partial, timed
      against the real one. Run with --platform cpu for the virtual
      CPU mesh.
  (c) A bandwidth/latency model of the inter-host network all-reduce
      combined with a MEASURED single-device EM iteration time and
      host-phase time (given as arguments, e.g. from bench.py and
      scripts/e2e_bench.py on the target host), evaluated for strong
      scaling (fixed total reads) and weak scaling (fixed per-host
      reads), plus the host-phase sharding of distributed ingest.

Usage: python scripts/multihost_eff.py --ms-per-iter MS
           --host-phases-s S [--platform cpu] [--quick]
"""

import argparse
import functools
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def make_csr(R, T, mean_k=3, seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.geometric(1.0 / mean_k, size=R).clip(1, 50)
    A = int(sizes.sum())
    boundaries = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(sizes, out=boundaries[1:])
    txp_id = (rng.zipf(1.3, size=A) % T).astype(np.int32)
    w = np.exp(rng.normal(0, 0.5, size=A)).astype(np.float64)
    return txp_id, w, boundaries, A


def measure_split(R, T, iters=30):
    """Per-iteration wall of the sharded segment-sum EM on the virtual
    mesh, with and without its psum (identical program otherwise)."""
    from oarfish_tpu.parallel.sharded_em import ShardedCsr

    txp_id, w, boundaries, A = make_csr(R, T)
    D = len(jax.devices())
    mesh = Mesh(np.array(jax.devices()), ("data",))
    sh = ShardedCsr(txp_id, w, boundaries, T, D)

    def m_step(prev, txp, wts, rid, perm, tsorted, do_psum):
        contrib = prev[txp] * wts
        denom = jax.ops.segment_sum(
            contrib, rid, sh.r_pad + 1, indices_are_sorted=True
        )
        scale = jnp.where(denom > 1e-30, 1.0 / denom, 0.0)
        inc = contrib * scale[rid]
        local = jax.ops.segment_sum(
            inc[perm], tsorted, T + 1, indices_are_sorted=True
        )
        return jax.lax.psum(local, "data") if do_psum else local

    def loop(do_psum):
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P("data", None),) * 5 + (P(),),
            out_specs=P(),
            check_vma=False,
        )
        def run(txp, wts, rid, perm, tsorted, init):
            def body(i, prev):
                return m_step(
                    prev, txp[0], wts[0], rid[0], perm[0], tsorted[0],
                    do_psum,
                )

            return jax.lax.fori_loop(0, iters, body, init)

        return jax.jit(run)

    args_dev = (
        jnp.asarray(sh.txp_id, jnp.int32),
        jnp.asarray(sh.weights, jnp.float32),
        jnp.asarray(sh.read_id, jnp.int32),
        jnp.asarray(sh.txp_sort_perm, jnp.int32),
        jnp.asarray(sh.txp_id_sorted, jnp.int32),
    )
    init = jnp.full(T + 1, 1.0, jnp.float32)
    out = {}
    for name, do_psum in (("full", True), ("no_psum", False)):
        fn = loop(do_psum)
        np.asarray(fn(*args_dev, init))  # compile + warm
        t0 = time.perf_counter()
        np.asarray(fn(*args_dev, init))
        out[name] = (time.perf_counter() - t0) / iters
    return out, A, D


def model_tables(T, ms_per_iter_1dev, A_ref, A_total, host_phases_s,
                 devs_per_host=4, net_bw=12.5e9, net_hop_s=25e-6):
    """All-reduce model + measured compute scaling over an inter-host
    network (default 100 Gbps = 12.5 GB/s, 25 us per hop; the devices
    inside one host are assumed to reduce far faster than that).
    Per-device compute: the measured ms/iter at A_ref scaled by shard
    size. Ring all-reduce: bytes_on_wire = 2*(H-1)/H * payload;
    latency 2*(H-1) * hop."""
    payload = 4.0 * T

    def t_comm_ms(H):
        if H == 1:
            return 0.0
        return 1000 * (2 * (H - 1) / H * payload / net_bw
                       + 2 * (H - 1) * net_hop_s)

    def t_comp_ms(A_per_dev):
        return ms_per_iter_1dev * A_per_dev / A_ref

    rows = {"strong": [], "weak": [], "e2e": []}
    t1_strong = t_comp_ms(A_total / devs_per_host)
    for H in (1, 2, 4, 8):
        tc = t_comp_ms(A_total / (devs_per_host * H))
        tt = tc + t_comm_ms(H)
        rows["strong"].append(
            (H, round(tc, 3), round(t_comm_ms(H), 3),
             round(t1_strong / (H * tt), 3))
        )
        # weak: per-device alignment count fixed at A_ref
        tcw = t_comp_ms(A_ref)
        rows["weak"].append(
            (H, round(tcw, 3), round(t_comm_ms(H), 3),
             round(tcw / (tcw + t_comm_ms(H)), 3))
        )
        # e2e strong: host phases shard with distributed ingest,
        # EM = iters * per-iter
        iters = 150
        e2e = host_phases_s / H + iters * tt / 1000
        e2e1 = host_phases_s + iters * t1_strong / 1000
        rows["e2e"].append((H, round(e2e, 2), round(e2e1 / (H * e2e), 3)))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--platform", default=None,
                    help="jax platform for the mesh split (cpu: the "
                         "virtual 8-device mesh)")
    ap.add_argument("--ms-per-iter", type=float, required=True,
                    help="measured single-device EM ms/iter at A=6M")
    ap.add_argument("--host-phases-s", type=float, required=True,
                    help="measured host-phase seconds of one A=15M run")
    args = ap.parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    R = 100_000 if args.quick else 500_000
    T = 20_000 if args.quick else 200_000

    split, A, D = measure_split(R, T)
    psum_ms = 1000 * max(split["full"] - split["no_psum"], 0.0)
    print(
        f"mesh ({D} {jax.default_backend()} devices, R={R}, A={A}, "
        f"T={T}): full {1000*split['full']:.2f} ms/iter, no-psum "
        f"{1000*split['no_psum']:.2f} ms/iter -> collective share "
        f"{psum_ms:.2f} ms/iter ({100*psum_ms/(1000*split['full']):.0f}%)"
    )
    print(f"psum payload: {4.0*(T+1)/1e6:.2f} MB f32 per iteration "
          f"(1 psum/iter; 3/cycle under SQUAREM)")

    rows = model_tables(
        T=250_000, ms_per_iter_1dev=args.ms_per_iter, A_ref=6_000_000,
        A_total=15_000_000, host_phases_s=args.host_phases_s,
    )
    print("\nall-reduce model @ config 3 (A=15M, T=250k, 4 devices/host, "
          "ring all-reduce over the inter-host network):")
    print("strong scaling (fixed 15M alignments):")
    print("  H  comp_ms  net_ms  eff")
    for r in rows["strong"]:
        print("  {:<2} {:>7} {:>7} {:>6}".format(*r))
    print("weak scaling (A=6M per device):")
    print("  H  comp_ms  net_ms  eff")
    for r in rows["weak"]:
        print("  {:<2} {:>7} {:>7} {:>6}".format(*r))
    print("e2e strong scaling (distributed ingest shards the host "
          "phases; 150 EM iters):")
    print("  H  e2e_s  eff")
    for r in rows["e2e"]:
        print("  {:<2} {:>6} {:>6}".format(*r))
    print("\nbootstrap replicates / single-cell batches: no per-"
          "iteration collective (replicate/cell axis sharded) -> "
          "efficiency ~1.0 by construction")
    print(json.dumps({
        "mesh_split_ms": {k: round(1000 * v, 3) for k, v in split.items()},
        "psum_payload_mb": round(4.0 * (T + 1) / 1e6, 3),
    }))


if __name__ == "__main__":
    main()
