#!/usr/bin/env python3
"""Smoke test of the main paths on one NVIDIA GPU, through the entry
points a user calls, at the scale of a human transcriptome.

Everything runs in this one process (a second JAX process could not
reserve the card's memory). Phases:

  (a) EM kernels: segsum, fast and v4 at R=2M reads, T=200k
      transcripts, A~6M alignments, 50 fixed f32 iterations, timed
      around block_until_ready after a warm-up; each compared with a
      vectorized NumPy f64 reference EM. segsum also runs in f64 and is
      compared at rtol 1e-9.
  (b) bulk: a synthetic name-collated BAM at the same R/T through
      `oarfish_tpu.cli.main` once per --em-impl (end-to-end seconds,
      cold and warm); the default run twice (byte-identity report);
      every out.quant checked against the reference at full
      convergence.
  (c) bootstraps: --num-bootstraps 8 through the CLI with segsum, fast
      and the default (end-to-end seconds, cold and warm), and
      replicate 0 of ops/bootstrap against the reference given the
      same multiplicities.
  (d) single-cell: 20,000 cells x 50 reads against 30,000 transcripts
      through --single-cell with the dense and the segsum cell EM; 64
      sampled cells against per-cell reference EMs.
  (e) --multi only, on four GPUs: --num-shards 4 through the CLI
      (segment-sum sharded EM, sharded v4, the 4-device single-cell
      mesh), each compared with the one-device run.

f32 tolerances (PARITY.md): relative mass error < 1e-5, relative
per-transcript L1 < 2e-3.

The last line of stdout is one JSON object
{"ok": ..., "device": {"platform", "kind", "count"}}. Without
--rehearse a first device that is not a GPU exits non-zero with no
result; --rehearse runs every phase at a tiny size on whatever JAX finds
(the CPU rehearsal).

Usage: python chip_smoke.py [--rehearse] [--multi]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 7

# reference constants (`src/util/constants.rs:1-2` of the reference)
MIN_READ_THRESH = 1e-5
EM_DENOM_THRESH = 1e-30
F32_MASS_TOL = 1e-5
F32_L1_TOL = 2e-3
F64_RTOL = 1e-9

FULL = dict(R=2_000_000, T=200_000, iters=50, runs=3, boots=8,
            sc_cells=20_000, sc_rpc=50, sc_T=30_000, sc_sample=64)
TINY = dict(R=20_000, T=1_000, iters=50, runs=1, boots=2,
            sc_cells=200, sc_rpc=20, sc_T=500, sc_sample=16)


def reference_em(txp_id, weights, boundaries, num_txps, max_iter=1000,
                 convergence_thresh=1e-3, multiplicity=None):
    """Vectorized NumPy f64 EM with the reference's serial semantics
    (`em.rs:87-255`): fused E/M step, reads with denominator <= 1e-30
    dropped, signed max relative change over transcripts above 1e-5,
    stop only after iteration 50, then zero counts below 1e-5 and run
    one final step. Independent of the package's JAX code."""
    txp_id = np.asarray(txp_id, dtype=np.int64)
    w = np.asarray(weights, dtype=np.float64)
    sizes = np.diff(np.asarray(boundaries, dtype=np.int64))
    R = len(sizes)
    read_id = np.repeat(np.arange(R), sizes)
    mult = None if multiplicity is None else np.asarray(
        multiplicity, dtype=np.float64)
    total = float(R) if mult is None else float(mult.sum())

    def step(prev):
        contrib = prev[txp_id] * w
        denom = np.bincount(read_id, weights=contrib, minlength=R)
        ok = denom > EM_DENOM_THRESH
        scale = np.zeros(R)
        scale[ok] = 1.0 / denom[ok]
        if mult is not None:
            scale *= mult
        return np.bincount(txp_id, weights=contrib * scale[read_id],
                           minlength=num_txps)

    prev = np.full(num_txps, total / num_txps)
    niter = 0
    while niter < max_iter:
        curr = step(prev)
        m = prev > MIN_READ_THRESH
        rd = 0.0
        if m.any():
            rd = max(rd, float(((curr[m] - prev[m]) / prev[m]).max()))
        prev = curr
        if rd < convergence_thresh and niter > 50:
            break
        niter += 1
    prev[prev < MIN_READ_THRESH] = 0.0
    return step(prev)


def f32_deviation(got, want):
    """(relative mass error, relative per-transcript L1)."""
    got = np.asarray(got, dtype=np.float64)
    total = float(want.sum())
    return (abs(float(got.sum()) - total) / total,
            float(np.abs(got - want).sum()) / total)


class Smoke:
    def __init__(self, cfg, tmp: Path):
        import jax

        self.cfg = cfg
        self.tmp = tmp
        self.jax = jax
        self.card = card_info()
        self.failures = []
        self.results = {}

    def say(self, msg):
        print(msg, flush=True)

    def timing(self, what, seconds):
        self.say(f"time [{self.card}] {what}: {seconds:.4f} s")

    def check_f32(self, what, got, want):
        mass, l1 = f32_deviation(got, want)
        ok = mass < F32_MASS_TOL and l1 < F32_L1_TOL
        self.say(f"check {what}: mass err {mass:.3e} (< {F32_MASS_TOL}), "
                 f"L1 {l1:.3e} (< {F32_L1_TOL}) -> "
                 f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what}: mass {mass:.3e}, L1 {l1:.3e}")
        return {"mass_err": mass, "l1": l1}

    def peak(self, phase):
        for d in self.jax.devices():
            st = d.memory_stats() or {}
            self.say(f"peak_bytes_in_use after {phase} on {d}: "
                     f"{st.get('peak_bytes_in_use', 'not reported')}")

    def cli(self, argv, what, env=None):
        """One in-process CLI run; returns wall seconds. Prints the
        driver's own EM, route-build and bootstrap log lines."""
        import logging

        from oarfish_tpu.cli import main as cli_main

        lines = []

        class Keep(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if any(k in msg for k in ("EM converged", "routing built",
                                          "bootstrap replicates", "shards",
                                          "em-impl auto", "cell EMs in",
                                          "sharded over")):
                    lines.append(msg)

        keep = Keep(logging.INFO)
        logging.getLogger("oarfish_tpu").addHandler(keep)
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            t0 = time.perf_counter()
            rc = cli_main([str(a) for a in argv])
            wall = time.perf_counter() - t0
        finally:
            logging.getLogger("oarfish_tpu").removeHandler(keep)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if rc != 0:
            raise AssertionError(f"{what}: CLI exit code {rc}")
        self.timing(f"cli {what}", wall)
        for ln in lines:
            self.say(f"  driver: {ln}")
        return wall

    def run_phase(self, name, fn):
        self.say(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — reported; makes ok false
            traceback.print_exc()
            self.failures.append(name)
            self.say(f"phase {name}: FAILED")
        else:
            self.say(f"phase {name}: ok")
        self.timing(f"phase {name} total", time.perf_counter() - t0)
        self.peak(name)

    # -- (a) ---------------------------------------------------------------
    def phase_em(self):
        import jax.numpy as jnp

        import bench

        c = self.cfg
        R, T, iters = c["R"], c["T"], c["iters"]
        txp_id, w, boundaries, read_id, A = bench.make_csr(R, T, SEED)
        self.say(f"EM kernels: R={R} T={T} A={A} iters={iters}")
        t0 = time.perf_counter()
        ref = reference_em(txp_id, w, boundaries, T, max_iter=iters,
                           convergence_thresh=-1.0)
        self.say(f"numpy f64 reference: {time.perf_counter() - t0:.2f} s")
        init = jnp.full(T, float(R) / T, dtype=jnp.float32)
        out = {}
        for impl in ("segsum", "fast", "v4"):
            run, build_s = bench.build_em(impl, txp_id, w, boundaries,
                                          read_id, T, jnp.float32)
            dt, counts = bench.time_em(run, init, iters, c["runs"])
            del run
            ms = 1000.0 * dt / iters
            self.say(f"em {impl}: build {build_s:.3f} s, "
                     f"{ms:.4f} ms/iter [{self.card}]")
            out[impl] = {"ms_per_iter": ms, "build_s": build_s,
                         **self.check_f32(f"em {impl} f32", counts, ref)}
        # f64 on the card: the oracle's semantics survive reordered sums
        self.jax.config.update("jax_enable_x64", True)
        try:
            run, _ = bench.build_em("segsum", txp_id, w, boundaries,
                                    read_id, T, jnp.float64)
            counts, _ = run(jnp.full(T, float(R) / T, jnp.float64), iters,
                            -1.0)
            got = np.asarray(counts, dtype=np.float64)
            del run, counts
        finally:
            self.jax.config.update("jax_enable_x64", False)
        dev = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
        worst = float(dev[np.abs(ref) > 1e-9].max())
        self.say(f"check em segsum f64: max rel dev {worst:.3e} "
                 f"(rtol {F64_RTOL})")
        np.testing.assert_allclose(got, ref, rtol=F64_RTOL, atol=1e-9)
        out["segsum_f64_max_rel_dev"] = worst
        self.results["em"] = out

    # -- (b) ---------------------------------------------------------------
    def bulk_fixture(self):
        """The synthetic BAM and its packed CSR (built once)."""
        if hasattr(self, "_bulk"):
            return self._bulk
        sys.path.insert(0, str(REPO / "scripts"))
        from e2e_bench import build_e2e_bam

        from oarfish_tpu.config import Args, resolve_filters
        from oarfish_tpu.host.packer import pack_bam_fast

        c = self.cfg
        bam = self.tmp / "bulk.bam"
        A, gen_s = build_e2e_bam(bam, c["R"], c["T"], seed=SEED)
        self.say(f"bulk BAM: R={c['R']} T={c['T']} A={A} "
                 f"{bam.stat().st_size} bytes, generated in {gen_s:.1f} s")
        args = Args(alignments=bam, output=self.tmp / "unused")
        _h, store, _cov, _u = pack_bam_fast(
            bam, resolve_filters(args), bin_width=args.bin_width,
            threads=self.threads(),
        )
        self._bulk = (bam, store)
        return self._bulk

    def threads(self):
        return min(os.cpu_count() or 4, 16)

    def read_quant(self, prefix):
        counts = np.loadtxt(f"{prefix}.quant", skiprows=1, usecols=2,
                            dtype=np.float64, ndmin=1)
        return counts

    def phase_bulk(self):
        from oarfish_tpu.host import native

        bam, store = self.bulk_fixture()
        loaded = native.available()
        self.say(f"BAM decoder: {'native' if loaded else 'python fallback'}")
        if not loaded:
            raise AssertionError("the native BAM decoder did not load")
        t0 = time.perf_counter()
        ref = reference_em(store.txp_id, store.as_prob, store.boundaries,
                           self.cfg["T"])
        self.say(f"numpy f64 reference (full convergence): "
                 f"{time.perf_counter() - t0:.2f} s")
        base = ["--alignments", bam, "--threads", self.threads()]
        e2e = {}
        for impl in ("segsum", "fast", "v4"):
            walls = []
            for rep in ("cold", "warm"):
                out = self.tmp / f"bulk_{impl}_{rep}"
                walls.append(self.cli(base + ["-o", out, "--em-impl", impl],
                                      f"bulk --em-impl {impl} ({rep})"))
            self.check_f32(f"bulk {impl} out.quant",
                           self.read_quant(out), ref)
            e2e[impl] = {"cold_s": walls[0], "warm_s": walls[1]}
        outs = []
        for rep in (1, 2):
            out = self.tmp / f"bulk_default_{rep}"
            e2e.setdefault("default", []).append(
                self.cli(base + ["-o", out], f"bulk default run {rep}"))
            outs.append(Path(f"{out}.quant").read_bytes())
        self.check_f32("bulk default out.quant", self.read_quant(out), ref)
        same = outs[0] == outs[1]
        self.say(f"bulk default: repeated out.quant byte-identical: {same}")
        e2e["byte_identical"] = same
        self.results["bulk"] = e2e

    # -- (c) ---------------------------------------------------------------
    def phase_bootstrap(self):
        import jax.numpy as jnp

        from oarfish_tpu.ops.bootstrap import bootstrap, sample_multiplicities
        from oarfish_tpu.ops.em import EmData

        bam, store = self.bulk_fixture()
        nb = self.cfg["boots"]
        res = {}
        for impl in ("segsum", "fast", "auto"):
            walls = []
            for rep in ("cold", "warm"):
                out = self.tmp / f"boot_{impl}_{rep}"
                walls.append(self.cli(
                    ["--alignments", bam, "--threads", self.threads(),
                     "-o", out, "--num-bootstraps", nb, "--em-impl", impl],
                    f"bulk --num-bootstraps {nb} --em-impl {impl} ({rep})"))
                pq = Path(f"{out}.infreps.pq")
                head = pq.read_bytes()[:4] if pq.exists() else b""
                if head != b"PAR1":
                    raise AssertionError(f"{pq} missing or not parquet")
            res[impl] = {"cold_s": walls[0], "warm_s": walls[1]}
        self.say(f"infreps: {pq.stat().st_size} bytes")
        T = self.cfg["T"]
        sizes = np.diff(store.boundaries)
        read_id = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
        data = EmData.build(store.txp_id, store.as_prob.astype(np.float64),
                            read_id, store.num_reads, T, dtype=jnp.float32)
        t0 = time.perf_counter()
        rep0 = bootstrap(data, 1, seed=SEED, dtype=jnp.float32)[0]
        self.timing("bootstrap replicate 0 (ops/bootstrap)",
                    time.perf_counter() - t0)
        mult = sample_multiplicities(np.random.default_rng(SEED), 1,
                                     store.num_reads)[0]
        ref = reference_em(store.txp_id, store.as_prob, store.boundaries, T,
                           multiplicity=mult)
        res.update(self.check_f32("bootstrap replicate 0", rep0, ref))
        self.results["bootstrap"] = res

    # -- (d) ---------------------------------------------------------------
    def sc_fixture(self):
        if hasattr(self, "_sc"):
            return self._sc
        sys.path.insert(0, str(REPO / "scripts"))
        from sc_e2e_bench import build_sc_bam

        c = self.cfg
        bam = self.tmp / "sc.bam"
        A, gen_s = build_sc_bam(bam, c["sc_cells"], c["sc_rpc"], c["sc_T"],
                                seed=SEED)
        self.say(f"single-cell BAM: {c['sc_cells']} cells x {c['sc_rpc']} "
                 f"reads, T={c['sc_T']}, A={A}, generated in {gen_s:.1f} s")
        self._sc = bam
        return bam

    def sc_reference(self, bam):
        """Per-cell reference EMs for a sample of cells, from the same
        host parse the driver uses: {cell index: f64 counts [T]}."""
        from oarfish_tpu.config import Args, resolve_filters
        from oarfish_tpu.quant.single_cell import _iter_cells_native

        c = self.cfg
        rng = np.random.default_rng(SEED)
        pick = set(rng.choice(c["sc_cells"], size=c["sc_sample"],
                              replace=False).tolist())
        args = Args(alignments=bam, output=self.tmp / "unused",
                    single_cell=True, threads=self.threads())
        _h, cells = _iter_cells_native(args, resolve_filters(args))
        ref = {}
        for idx, (_bc, cell) in enumerate(cells):
            if idx in pick and cell is not None:
                txp, _s, _e, prob, b = cell
                ref[idx] = reference_em(txp, prob, b, c["sc_T"])
        return ref

    def read_mtx(self, prefix, rows):
        m = np.loadtxt(f"{prefix}.count.mtx", skiprows=2, ndmin=2)
        out = {}
        for r in rows:
            sel = m[:, 0] == r + 1
            v = np.zeros(self.cfg["sc_T"])
            v[m[sel, 1].astype(np.int64) - 1] = m[sel, 2]
            out[r] = v
        return out

    def check_cells(self, what, prefix, ref):
        got = self.read_mtx(prefix, sorted(ref))
        worst_mass = worst_l1 = 0.0
        for r, want in ref.items():
            mass, l1 = f32_deviation(got[r], want)
            worst_mass, worst_l1 = max(worst_mass, mass), max(worst_l1, l1)
        ok = worst_mass < F32_MASS_TOL and worst_l1 < F32_L1_TOL
        self.say(f"check {what}: {len(ref)} cells, worst mass err "
                 f"{worst_mass:.3e}, worst L1 {worst_l1:.3e} -> "
                 f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what}: cells deviate from reference")
        return {"mass_err": worst_mass, "l1": worst_l1}

    def phase_single_cell(self):
        bam = self.sc_fixture()
        ref = self.sc_reference(bam)
        res = {}
        for impl in ("dense", "segsum"):
            walls = []
            for rep in ("cold", "warm"):
                out = self.tmp / f"sc_{impl}_{rep}"
                walls.append(self.cli(
                    ["--alignments", bam, "--single-cell", "-o", out,
                     "--threads", self.threads()],
                    f"single-cell {impl} ({rep})",
                    env={"OARFISH_SC_IMPL": impl}))
            res[impl] = {"cold_s": walls[0], "warm_s": walls[1],
                         **self.check_cells(f"single-cell {impl}", out, ref)}
        self.results["single_cell"] = res

    # -- (e) ---------------------------------------------------------------
    def phase_multi(self):
        devs = self.jax.devices()
        if len(devs) < 4:
            raise AssertionError(f"--multi needs 4 devices, found {len(devs)}")
        bam, _store = self.bulk_fixture()
        base = ["--alignments", bam, "--threads", self.threads()]
        one = self.tmp / "multi_one"
        self.cli(base + ["-o", one, "--num-shards", 1], "bulk on one device")
        want = self.read_quant(one)
        res = {}
        for impl in ("auto", "v4"):
            out = self.tmp / f"multi_{impl}"
            res[impl] = {"wall_s": self.cli(
                base + ["-o", out, "--num-shards", 4, "--em-impl", impl],
                f"bulk --num-shards 4 --em-impl {impl}")}
            res[impl].update(self.check_f32(
                f"sharded {impl} vs one device", self.read_quant(out), want))
        sc = self.sc_fixture()
        for shards in (1, 4):
            self.cli(["--alignments", sc, "--single-cell", "--threads",
                      self.threads(), "-o", self.tmp / f"sc_shards{shards}",
                      "--num-shards", shards],
                     f"single-cell --num-shards {shards}")
        rows = range(min(self.cfg["sc_cells"], 256))
        a = self.read_mtx(self.tmp / "sc_shards1", rows)
        b = self.read_mtx(self.tmp / "sc_shards4", rows)
        worst = max(f32_deviation(b[r], a[r])[1] for r in rows
                    if a[r].sum() > 0)
        self.say(f"check single-cell 4-shard vs one device: worst L1 "
                 f"{worst:.3e}")
        if worst >= F32_L1_TOL:
            raise AssertionError("sharded single-cell deviates")
        used = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                for d in devs[:4]]
        self.say(f"peak bytes per device: {used}")
        if self.jax.default_backend() == "gpu" and not all(used):
            raise AssertionError("shards did not land on all four devices")
        self.results["multi"] = res


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    return "; ".join(lines) if lines else "nvidia-smi not available"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="every phase at a tiny size on whatever platform "
                         "JAX finds (CPU rehearsal)")
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-device phase (e)")
    opts = ap.parse_args()
    if opts.rehearse and opts.multi:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=4"
            ).strip()

    # the repo's own modules: outside a checkout this fails before any
    # result is printed
    import bench  # noqa: F401
    import oarfish_tpu.cli  # noqa: F401

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not opts.rehearse:
        sys.stderr.write(f"chip_smoke: first device is {dev.platform!r}, "
                         "not a GPU (use --rehearse off the card)\n")
        return 2
    import logging

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    cfg = TINY if opts.rehearse else FULL
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        s = Smoke(cfg, Path(td))
        s.say(f"nvidia-smi: {s.card}")
        s.say(f"jax {jax.__version__}, device {dev.platform} "
              f"{dev.device_kind}, {len(jax.devices())} device(s)")
        if opts.multi:
            s.run_phase("e multi-device", s.phase_multi)
        else:
            s.run_phase("a em kernels", s.phase_em)
            s.run_phase("b bulk cli", s.phase_bulk)
            s.run_phase("c bootstraps", s.phase_bootstrap)
            s.run_phase("d single-cell", s.phase_single_cell)
        s.say("results: " + json.dumps(s.results, default=float))
        ok = not s.failures
        if not ok:
            s.say(f"failed phases: {s.failures}")
    print(json.dumps({"ok": ok, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
