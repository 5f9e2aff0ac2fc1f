"""End-to-end bulk quantification through the CLI, validated against an
independent oracle pipeline (host pack + NumPy f64 EM)."""

import json
from pathlib import Path

import numpy as np
import pytest

from oarfish_tpu.cli import main
from oarfish_tpu.config import Args, FilterOpts
from oarfish_tpu.host.packer import pack_bam
from oarfish_tpu.io.bam import BamReader
from oarfish_tpu.models.coverage import logistic_prob, normalize_read_probs
from oarfish_tpu.ops.em_oracle import combine_weights, do_em_oracle
from util_sim import simulate_bam


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = tmp_path_factory.mktemp("bulk")
    p = d / "sirv_sim.bam"
    names, lengths, truth = simulate_bam(p, num_reads=800, seed=11)
    return d, p, names, lengths, truth


def oracle_counts(bam_path, lengths, model_coverage=False, bin_width=100):
    reader = BamReader(bam_path)
    opts = FilterOpts(model_coverage=model_coverage)
    store, cov, _ = pack_bam(
        reader, np.asarray(lengths), opts, bin_width=bin_width
    )
    if model_coverage:
        flat = logistic_prob(cov, 2.0)
        normalize_read_probs(store, cov, flat, bin_width)
    w = combine_weights(store.as_prob, store.cov_prob, model_coverage)
    return do_em_oracle(store.txp_id, w, store.boundaries, len(lengths))


def read_quant(path):
    names, lens, counts = [], [], []
    with open(path) as fh:
        assert fh.readline() == "tname\tlen\tnum_reads\n"
        for line in fh:
            n, l, c = line.rstrip("\n").split("\t")
            names.append(n)
            lens.append(int(l))
            counts.append(float(c))
    return names, lens, np.array(counts)


def test_cli_bulk_basic(sim):
    d, p, names, lengths, truth = sim
    out = d / "basic" / "q"
    rc = main(["--alignments", str(p), "-o", str(out), "--em-dtype", "float64",
               "--quiet"])
    assert rc == 0
    qn, ql, qc = read_quant(str(out) + ".quant")
    assert qn == names and ql == lengths
    want = oracle_counts(p, lengths)
    np.testing.assert_allclose(qc, want, rtol=1e-9, atol=1e-9)

    meta = json.loads(Path(str(out) + ".meta_info.json").read_text())
    assert meta["prob_model"] == "no_coverage"
    assert meta["alignment_source"] == "from_bam"
    assert meta["num_bootstraps"] == 0
    assert meta["digest"]["bam_digest"]["seqcol_digest"]["names"]

    ambig = Path(str(out) + ".ambig_info.tsv").read_text().splitlines()
    assert ambig[0] == "unique_reads\tambig_reads\ttotal_reads"
    assert len(ambig) == len(names) + 1
    # total records across transcripts == packed alignments
    tot = sum(int(x.split("\t")[2]) for x in ambig[1:])
    reader = BamReader(p)
    store, _, _ = pack_bam(reader, np.asarray(lengths), FilterOpts(), 100)
    assert tot == store.num_alignments


def test_cli_bulk_coverage_model(sim):
    d, p, names, lengths, truth = sim
    out = d / "cov" / "q"
    rc = main(["--alignments", str(p), "-o", str(out), "--model-coverage",
               "--em-dtype", "float64", "--quiet"])
    assert rc == 0
    _, _, qc = read_quant(str(out) + ".quant")
    want = oracle_counts(p, lengths, model_coverage=True)
    np.testing.assert_allclose(qc, want, rtol=1e-9, atol=1e-9)
    meta = json.loads(Path(str(out) + ".meta_info.json").read_text())
    assert meta["prob_model"] == "logistic_coverage"
    assert meta["filter_options"]["model_coverage"] is True


def test_cli_bootstraps(sim):
    import pyarrow.parquet as pq

    d, p, names, lengths, truth = sim
    out = d / "boot" / "q"
    rc = main(["--alignments", str(p), "-o", str(out), "--num-bootstraps", "8",
               "--em-dtype", "float64", "--quiet"])
    assert rc == 0
    t = pq.read_table(str(out) + ".infreps.pq")
    assert t.column_names == [f"bootstrap.{i}" for i in range(8)]
    assert t.num_rows == len(names)
    reps = np.stack([t.column(i).to_numpy() for i in range(8)])
    _, _, qc = read_quant(str(out) + ".quant")
    # bootstrap means should be near the point estimate for expressed txps
    hi = qc > 20
    assert hi.any()
    rel = np.abs(reps.mean(axis=0)[hi] - qc[hi]) / qc[hi]
    assert (rel < 0.5).all()
    # replicates differ from one another (actually resampled)
    assert np.std(reps, axis=0)[hi].max() > 0


def test_cli_sharded_v4_bootstraps(sim):
    """--num-shards with --em-impl v4 and bootstraps: the point EM and
    the replicate batches both run through the mesh (vmapped replicates
    under one shard_map program)."""
    import pyarrow.parquet as pq

    d, p, names, lengths, truth = sim
    out = d / "shboot" / "q"
    rc = main(["--alignments", str(p), "-o", str(out),
               "--num-bootstraps", "4", "--num-shards", "2",
               "--em-impl", "v4", "--em-dtype", "float64", "--quiet"])
    assert rc == 0
    _, _, qc = read_quant(str(out) + ".quant")
    want = oracle_counts(p, lengths)
    np.testing.assert_allclose(qc, want, rtol=1e-5, atol=1e-6)
    t = pq.read_table(str(out) + ".infreps.pq")
    assert t.column_names == [f"bootstrap.{i}" for i in range(4)]
    reps = np.stack([t.column(i).to_numpy() for i in range(4)])
    assert np.isfinite(reps).all()
    # each replicate conserves its resampled read mass
    np.testing.assert_allclose(reps.sum(axis=1), qc.sum(), rtol=0.05)


def test_cli_write_probs(sim):
    d, p, names, lengths, truth = sim
    out = d / "probs" / "q"
    rc = main(["--alignments", str(p), "-o", str(out),
               "--write-assignment-probs", "--em-dtype", "float64", "--quiet"])
    assert rc == 0
    lines = Path(str(out) + ".prob").read_text().splitlines()
    ntxp, nreads = map(int, lines[0].split("\t"))
    assert ntxp == len(names)
    assert lines[1 : 1 + ntxp] == names
    body = lines[1 + ntxp :]
    assert len(body) == nreads
    for line in body[:50]:
        parts = line.split("\t")
        k = int(parts[1])
        probs = [float(x) for x in parts[2 + k : 2 + 2 * k]]
        if k:
            assert abs(sum(probs) - 1.0) < 1e-3
        # default display-thresh 1e-6 -> 6 decimals
        if k:
            assert len(parts[2 + k].split(".")[-1]) == 6


def test_cli_write_probs_lz4(sim):
    from oarfish_tpu.utils.lz4f import decompress_frame

    d, p, names, lengths, truth = sim
    out = d / "probslz" / "q"
    rc = main(["--alignments", str(p), "-o", str(out),
               "--write-assignment-probs=lz4", "--em-dtype", "float64",
               "--quiet"])
    assert rc == 0
    raw = decompress_frame(Path(str(out) + ".prob.lz4").read_bytes())
    plain = Path(str(d / "probs" / "q") + ".prob").read_bytes()
    assert raw == plain


def test_cli_filter_group_nanocount(sim):
    d, p, names, lengths, truth = sim
    out = d / "nano" / "q"
    rc = main(["--alignments", str(p), "-o", str(out), "--filter-group",
               "nanocount-filters", "--em-dtype", "float64", "--quiet"])
    assert rc == 0
    meta = json.loads(Path(str(out) + ".meta_info.json").read_text())
    fo = meta["filter_options"]
    assert fo["three_prime_clip"] == 50
    assert fo["which_strand"] == "Forward"
    assert meta["filter_group"] == "NanocountFilters"


def test_cli_mode_validation(sim, capsys):
    d, p, *_ = sim
    with pytest.raises(SystemExit):
        main(["-o", "x"])  # no input mode
    with pytest.raises(SystemExit):
        main(["--alignments", str(p)])  # no output
    with pytest.raises(SystemExit):
        main(["--reads", "r.fq", "-o", "x"])  # no reference/seq-tech


def test_cli_em_impl_v4_cpu_fallback(sim, caplog):
    """--em-impl v4 runs its plain-JAX routing stages on the CPU test
    backend (no downgrade) and matches the segsum run to f32 tolerances
    (v4 iterates in f32)."""
    import logging

    d, p, names, lengths, truth = sim
    out = {}
    for impl in ("segsum", "v4"):
        out[impl] = d / f"impl_{impl}" / "q"
        with caplog.at_level(logging.INFO, logger="oarfish_tpu"):
            rc = main(["--alignments", str(p), "-o", str(out[impl]),
                       "--em-dtype", "float64", "--em-impl", impl])
        assert rc == 0
    assert "v4 routing built" in caplog.text
    assert "routing unavailable" not in caplog.text
    _, _, seg = read_quant(str(out["segsum"]) + ".quant")
    _, _, v4 = read_quant(str(out["v4"]) + ".quant")
    assert abs(v4.sum() - seg.sum()) / seg.sum() < 1e-5
    assert np.abs(v4 - seg).sum() / seg.sum() < 2e-3


def test_cli_em_accel_squarem(sim):
    """--em-accel squarem converges to the same quantification as the
    plain EM (same fixed point; stopping-rule-level tolerance)."""
    d, p, names, lengths, truth = sim
    out = d / "squarem" / "q"
    rc = main([
        "--alignments", str(p), "-o", str(out), "--em-dtype", "float64",
        "--em-accel", "squarem", "--num-bootstraps", "3", "--quiet",
    ])
    assert rc == 0
    qn, ql, qc = read_quant(str(out) + ".quant")
    assert qn == names
    want = oracle_counts(p, lengths)
    assert abs(qc.sum() - want.sum()) < 1e-6 * max(want.sum(), 1)
    np.testing.assert_allclose(qc, want, rtol=5e-3, atol=0.05)
    assert (Path(str(out) + ".infreps.pq")).exists()


def test_write_out_prob_matches_scalar_oracle(tmp_path):
    """The vectorized .prob writer reproduces a scalar transliteration
    of the reference's write_out_prob (`write_function.rs:226-340`)
    byte-for-byte, including k=0 trailing tabs and NaN-denominator
    reads."""
    from oarfish_tpu.host.filters import DiscardTable
    from oarfish_tpu.host.store import AlignmentStore, NameBlob
    from oarfish_tpu.quant.writers import (
        prob_display_decimals,
        write_out_prob,
    )

    rng = np.random.default_rng(9)
    R, T = 400, 12
    sizes = rng.integers(1, 6, R)
    bd = np.zeros(R + 1, np.int64)
    np.cumsum(sizes, out=bd[1:])
    A = int(bd[-1])
    tid = rng.integers(0, T, A).astype(np.int32)
    prob = rng.random(A).astype(np.float32)
    counts = rng.random(T) * 50
    counts[3] = 0.0  # some zero-count transcripts
    names = NameBlob()
    for r in range(R):
        names.append(f"rd{r}\x00" if r % 7 == 0 else f"rd{r}")
    store = AlignmentStore(
        txp_id=tid, start=np.ones(A, np.int64), end=np.ones(A, np.int64),
        as_prob=prob, cov_prob=np.ones(A), boundaries=bd,
        discard=DiscardTable(), read_names=names,
    )
    # make a few reads have denom == 0 (all their transcripts at 0)
    z = rng.choice(R, 5, replace=False)
    for r in z:
        tid[bd[r] : bd[r + 1]] = 3

    thresh = 1e-4
    out = tmp_path / "v"
    write_out_prob(out, store, counts, [f"t{i}" for i in range(T)],
                   thresh, False, compressed=False)
    got = (tmp_path / "v.prob").read_bytes()

    # scalar transliteration (sequential f64 sums like the reference)
    decimals = prob_display_decimals(thresh)
    lines = [f"{T}\t{R}"] + [f"t{i}" for i in range(T)]
    for r in range(R):
        s, e = int(bd[r]), int(bd[r + 1])
        den = 0.0
        ws = []
        for a in range(s, e):
            wv = float(counts[tid[a]]) * float(np.float64(prob[a]))
            ws.append(wv)
            den += wv
        kt, kp = [], []
        for a, wv in zip(range(s, e), ws):
            np_v = min(max(wv / den, 0.0), 1.0) if den != 0.0 else float("nan")
            if np_v >= thresh:
                kt.append(int(tid[a]))
                kp.append(np_v)
        d2 = sum(kp)
        if d2 != 0:
            kp = [p / d2 for p in kp]
        nm = names[r].rstrip("\x00")
        ids = "\t".join(str(t) for t in kt)
        pv = "\t".join(f"{p:.{decimals}f}" for p in kp)
        lines.append(f"{nm}\t{len(kt)}\t{ids}\t{pv}")
    want = ("\n".join(lines) + "\n").encode()
    assert got == want


def test_pack_chunk_observer_prebuild(sim):
    """The streaming pack's chunk_observer feeds V4Prebuild slices that
    reassemble to exactly the packed store (the pack→layout overlap
    path, `bulk.rs:364-682` producer→consumer shape)."""
    from oarfish_tpu.host.packer import pack_bam_fast
    from oarfish_tpu.ops.em_v4 import V4Prebuild

    _d, bam, names, lengths, _truth = sim
    pb = V4Prebuild()
    header, store, coverage, _ = pack_bam_fast(
        bam, FilterOpts(), bin_width=100, threads=2,
        chunk_observer=pb.observe,
    )
    pre = pb.finish(len(names))
    assert pre is not None
    assert pre["A"] == store.num_alignments
    assert pre["R"] == store.num_reads
    want_counts = np.bincount(store.txp_id, minlength=len(names))
    assert np.array_equal(pre["counts"], want_counts)
    sizes = np.diff(store.boundaries)
    # every read appears in exactly one size class
    total = sum(len(v) for v in pre["classes"].values())
    assert total == store.num_reads
    for K, ids in pre["classes"].items():
        s = sizes[ids]
        assert (s <= K).all() and (s > K // 2).all()


def test_prefetch_hedge_abort_and_survive(sim, monkeypatch, tmp_path):
    """The prefetch hedge (VERDICT r3 / ADVICE r3): when a plan prefetch
    is in flight at run start, the V4Prebuild hedge keeps running until
    the prefetch payload is known-loadable, then is quietly aborted; if
    the prefetch load FAILS, the prebuilder survives and supplies `pre`.
    Either way the quant output is identical to the no-prefetch run."""
    from oarfish_tpu.quant import bulk as bulk_mod
    from oarfish_tpu.ops import plan_cache
    from oarfish_tpu.ops.em_v4 import V4Prebuild

    d, p, names, lengths, _truth = sim

    spies = []

    class SpyPrebuild(V4Prebuild):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.aborted_quiet = False
            self.observed = 0
            spies.append(self)

        def observe(self, packed):
            self.observed += 1
            super().observe(packed)

        def abort(self, quiet=False):
            if quiet:
                self.aborted_quiet = True
            super().abort(quiet=quiet)

    monkeypatch.setattr(
        "oarfish_tpu.ops.em_v4.V4Prebuild", SpyPrebuild
    )

    class FakePrefetch:
        def __init__(self, status):
            self._status = status
            self.key = "fake"

        def status(self):
            return self._status

        def finish(self, structural_key, weights):
            return None  # always "stale": build falls back

    # baseline: no prefetch at all
    monkeypatch.setattr(plan_cache, "prefetch_for_bam", lambda *_: None)
    out0 = tmp_path / "none"
    assert main(["--alignments", str(p), "-o", str(out0),
                 "--em-impl", "v4", "--quiet"]) == 0
    _, _, c0 = read_quant(str(out0) + ".quant")
    assert spies and spies[-1].observed > 0
    assert not spies[-1].aborted_quiet

    # prefetch loads OK -> hedge must be quietly aborted mid-pack
    monkeypatch.setattr(
        plan_cache, "prefetch_for_bam", lambda *_: FakePrefetch("ok")
    )
    out1 = tmp_path / "ok"
    assert main(["--alignments", str(p), "-o", str(out1),
                 "--em-impl", "v4", "--quiet"]) == 0
    _, _, c1 = read_quant(str(out1) + ".quant")
    assert spies[-1].aborted_quiet
    np.testing.assert_allclose(c1, c0, rtol=1e-6)

    # prefetch load FAILS -> hedge survives, observes every chunk
    monkeypatch.setattr(
        plan_cache, "prefetch_for_bam", lambda *_: FakePrefetch("failed")
    )
    out2 = tmp_path / "failed"
    assert main(["--alignments", str(p), "-o", str(out2),
                 "--em-impl", "v4", "--quiet"]) == 0
    _, _, c2 = read_quant(str(out2) + ".quant")
    assert not spies[-1].aborted_quiet
    assert spies[-1].observed == spies[0].observed
    np.testing.assert_allclose(c2, c0, rtol=1e-6)
