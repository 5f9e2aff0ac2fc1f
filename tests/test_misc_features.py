"""Long-tail feature coverage: --use-kde, uBAM read source, short-read
seeding, digests."""

import json
from pathlib import Path

import numpy as np
import pytest

from oarfish_tpu.cli import main
from oarfish_tpu.io import bam
from oarfish_tpu.io.fasta import iter_fastx, sniff_format
from util_sim import simulate_bam


def test_use_kde_end_to_end(tmp_path):
    p = tmp_path / "s.bam"
    names, lengths, truth = simulate_bam(p, num_reads=400, seed=21)
    out = tmp_path / "q"
    rc = main(["--alignments", str(p), "-o", str(out), "--use-kde",
               "--em-dtype", "float64", "--quiet"])
    assert rc == 0
    lines = Path(str(out) + ".quant").read_text().splitlines()
    counts = np.array([float(l.split("\t")[2]) for l in lines[1:]])
    # KDE reweights but conserves read mass for assigned reads
    assert counts.sum() == pytest.approx(400, rel=0.02)


def test_short_quant_seeding(tmp_path):
    p = tmp_path / "s.bam"
    names, lengths, truth = simulate_bam(p, num_reads=300, seed=22)
    sq = tmp_path / "short.tsv"
    with open(sq, "w") as fh:
        fh.write("Name\tLength\tEffectiveLength\tTPM\tNumReads\n")
        for n, L in zip(names, lengths):
            fh.write(f"{n}\t{L}\t{L}\t1.0\t{5.0}\n")
    out = tmp_path / "q"
    rc = main(["--alignments", str(p), "-o", str(out), "-q", str(sq),
               "--em-dtype", "float64", "--quiet"])
    assert rc == 0
    meta = json.loads(Path(str(out) + ".meta_info.json").read_text())
    assert meta["short_quant"] == str(sq)

    # unknown transcript in the seed file is an error
    bad = tmp_path / "bad.tsv"
    with open(bad, "w") as fh:
        fh.write("Name\tLength\tEffectiveLength\tTPM\tNumReads\n")
        fh.write("NOT_A_TXP\t100\t100\t1.0\t2.0\n")
    with pytest.raises(ValueError, match="didn't appear"):
        main(["--alignments", str(p), "-o", str(tmp_path / "q2"),
              "-q", str(bad), "--quiet"])


def test_ubam_read_source(tmp_path):
    # unaligned BAM as a raw-read source: sequences extracted with U->T
    recs = [
        dict(name="r1", flag=bam.FLAG_UNMAPPED, ref_id=-1, pos=-1, cigar="",
             seq="ACGTACGTAA"),
        dict(name="r2 extra-comment", flag=bam.FLAG_UNMAPPED, ref_id=-1,
             pos=-1, cigar="", seq="GGGGCCCC"),
    ]
    p = tmp_path / "u.bam"
    bam.write_bam(p, ["dummy"], [100], recs)
    assert sniff_format(p) == "bam"
    got = list(iter_fastx(p))
    assert got[0] == ("r1", b"ACGTACGTAA")
    assert got[1][0] == "r2"
    assert got[1][1] == b"GGGGCCCC"


def test_fastx_sniffing_and_u2t(tmp_path):
    fa = tmp_path / "x.fa"
    fa.write_text(">a desc\nACGU\nUUAA\n>b\nGGCC\n")
    assert sniff_format(fa) == "fasta"
    got = dict(iter_fastx(fa))
    assert got["a"] == b"ACGTTTAA"
    assert got["b"] == b"GGCC"

    import gzip

    fq = tmp_path / "x.fq.gz"
    with gzip.open(fq, "wt") as fh:
        fh.write("@r1 c\nacgu\n+\nIIII\n")
    assert sniff_format(fq) == "fastq"
    got = list(iter_fastx(fq))
    assert got[0] == ("r1", b"acgt")


def test_digest_footer_roundtrip(tmp_path):
    from oarfish_tpu.utils.digest import (
        append_digest_footer,
        read_digest_footer,
        seqcol_level1,
    )

    f = tmp_path / "idx.bin"
    f.write_bytes(b"\x00" * 100)
    digest = {"d": seqcol_level1(["a", "b"], [10, 20])}
    append_digest_footer(str(f), digest)
    assert read_digest_footer(str(f)) == digest
    # digests are deterministic and order-sensitive
    assert seqcol_level1(["a", "b"], [10, 20]) == seqcol_level1(
        ["a", "b"], [10, 20]
    )
    assert seqcol_level1(["a", "b"], [10, 20]) != seqcol_level1(
        ["b", "a"], [10, 20]
    )


def test_pair_digest_fast_path_matches_canonical_json():
    """seqcol_level1 assembles pair-digest bytes directly for plain
    names; the digest must equal the json.dumps canonical form for any
    name, including ones that need real JSON escaping (fallback path)."""
    import base64
    import hashlib
    import json

    from oarfish_tpu.utils.digest import seqcol_level1

    names = ["t1", "weird\"quote", "back\\slash", "tab\tname",
             "unicode-é-名", "", "spaces ok", "ctrl\x01char"]
    lengths = [5, 10, 15, 20, 25, 30, 35, 40]

    def ref_pairs(ns, ls):
        ds = sorted(
            base64.urlsafe_b64encode(
                hashlib.sha512(
                    json.dumps(
                        {"length": int(l), "name": n},
                        separators=(",", ":"), sort_keys=True,
                        ensure_ascii=False,
                    ).encode()
                ).digest()[:24]
            ).decode("ascii")
            for n, l in zip(ns, ls)
        )
        return base64.urlsafe_b64encode(
            hashlib.sha512(
                json.dumps(ds, separators=(",", ":"), sort_keys=True,
                           ensure_ascii=False).encode()
            ).digest()[:24]
        ).decode("ascii")

    got = seqcol_level1(names, lengths)["sorted_name_length_pairs"]
    assert got == ref_pairs(names, lengths)


def test_lazy_digest_resolution():
    from oarfish_tpu.utils.digest import (
        LazyDigest,
        digest_from_header,
        resolve_lazy_digests,
    )

    lazy = {"bam_digest": LazyDigest(digest_from_header, ["a", "b"], [1, 2])}
    assert resolve_lazy_digests(lazy)["bam_digest"] == digest_from_header(
        ["a", "b"], [1, 2]
    )

    def boom():
        raise ValueError("digest failed")

    import pytest

    with pytest.raises(ValueError, match="digest failed"):
        resolve_lazy_digests({"d": LazyDigest(boom)})


def test_choose_auto_impl_policy(tmp_path, caplog):
    """`--em-impl auto` is the segment-sum EM on every backend (chosen
    from end-to-end GPU times; fast and v4 lost there), with or without
    bootstraps."""
    import logging

    from oarfish_tpu.quant.bulk import AUTO_EM_IMPL

    assert AUTO_EM_IMPL == "segsum"
    p = tmp_path / "s.bam"
    simulate_bam(p, num_reads=300, seed=5)
    with caplog.at_level(logging.INFO, logger="oarfish_tpu"):
        assert main(["--alignments", str(p), "-o", str(tmp_path / "q"),
                     "--num-bootstraps", "2"]) == 0
    assert "em-impl auto -> segsum" in caplog.text
