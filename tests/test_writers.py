"""Writer-layer unit tests: the vectorized Rust-Display f64 formatter
and the vectorized `.quant` / `.ambig_info.tsv` / `.count.mtx` line
assembly (reference writers: `write_function.rs:73-148,25-70`).

The golden CLI tests (`test_golden.py`) pin full-file bytes; these tests
target the formatter's value-space corners directly (the goldens only
exercise the values a tiny SIRV run happens to produce).
"""

import numpy as np
import pytest

from oarfish_tpu.quant.writers import (
    get_aux_counts,
    rust_f64_str,
    rust_f64_str_vec,
    write_output,
    write_single_cell_output,
)


def test_rust_f64_str_vec_matches_scalar():
    rng = np.random.default_rng(7)
    vals = np.concatenate([
        # EM-count-like magnitudes
        rng.uniform(0, 1e6, 2000),
        rng.uniform(0, 1.0, 2000),
        # exact integers (the dominant .quant case)
        rng.integers(0, 10**9, 1000).astype(np.float64),
        # tiny survivors of the final m-step
        10.0 ** rng.uniform(-9, -3, 500),
        # exponent-range stragglers (fallback path)
        10.0 ** rng.uniform(-30, -10, 50),
        10.0 ** rng.uniform(16, 30, 50),
        # corners
        np.array([0.0, -0.0, 1e-5, 1.5, 2.5, 0.1, 1 / 3, np.nan,
                  float(2**53 - 1), 1e16, 1e15 + 0.5, 709.7827128933841]),
    ])
    got = rust_f64_str_vec(vals)
    want = [rust_f64_str(float(v)).encode() for v in vals]
    bad = [(v, g, w) for v, g, w in zip(vals, got, want) if g != w]
    assert not bad, bad[:10]


def test_native_fmt_matches_scalar():
    """csrc/fmt.cpp's Rust-Display formatter is byte-exact vs the
    Python reference implementation across the value-space corners."""
    from oarfish_tpu.host import fmt_native

    assert fmt_native.get_lib() is not None, "fmt library must build here"
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        rng.uniform(0, 1e6, 3000),
        rng.integers(0, 10**12, 1000).astype(np.float64),
        10.0 ** rng.uniform(-30, 20, 500),
        -rng.uniform(0, 1e3, 200),
        np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-5, 0.1, 1 / 3,
                  float(2**53 - 1), 1e16, 4.306340248200414e+16,
                  5e-324, 2.2250738585072014e-308]),
    ])
    buf, off = fmt_native.fmt_f64_tokens(vals)
    got = [buf[off[i]:off[i + 1]] for i in range(len(vals))]
    want = [rust_f64_str(float(v)).encode() for v in vals]
    bad = [(v, g, w) for v, g, w in zip(vals, got, want) if g != w]
    assert not bad, bad[:10]


def test_native_lines_match_fallback(tmp_path):
    """Native .mtx/.quant/.ambig bodies == the numpy fallback bodies."""
    from oarfish_tpu.host import fmt_native

    rng = np.random.default_rng(5)
    n = 10_000
    rows = rng.integers(0, 1000, n)
    cols = rng.integers(0, 5000, n)
    vals = np.where(rng.random(n) < 0.5,
                    rng.integers(0, 100, n).astype(float),
                    rng.uniform(0, 100, n))
    native = fmt_native.mtx_lines(rows, cols, vals)
    fallback = b"".join(
        (np.char.mod(b"%d ", rows + 1).astype(object)
         + np.char.mod(b"%d ", cols + 1).astype(object)
         + rust_f64_str_vec(vals) + b"\n").tolist())
    assert native == fallback

    u = rng.integers(0, 50, n)
    t = u + rng.integers(0, 50, n)
    native = fmt_native.ambig_lines(u, t)
    fallback = b"".join(
        (np.char.mod(b"%d\t", u).astype(object)
         + np.char.mod(b"%d\t", (t - u)).astype(object)
         + np.char.mod(b"%d\n", t).astype(object)).tolist())
    assert native == fallback


def test_rust_f64_str_vec_roundtrips():
    rng = np.random.default_rng(11)
    vals = rng.uniform(0, 1e7, 5000)
    got = rust_f64_str_vec(vals)
    back = np.array([float(g) for g in got])
    assert np.array_equal(back, vals)


def test_write_output_vectorized_bytes(tmp_path):
    names = ["txA", "txB", "txC"]
    lens = [100, 2500, 7]
    counts = np.array([0.0, 1234.0, 56.789])
    uniq = np.array([0, 900, 10])
    total = np.array([3, 1000, 12])
    out = tmp_path / "q"
    write_output(out, {"k": 1}, names, lens, counts, uniq, total)
    quant = (tmp_path / "q.quant").read_bytes()
    assert quant == (
        b"tname\tlen\tnum_reads\n"
        b"txA\t100\t0\n"
        b"txB\t2500\t1234\n"
        b"txC\t7\t56.789\n"
    )
    ambig = (tmp_path / "q.ambig_info.tsv").read_bytes()
    assert ambig == (
        b"unique_reads\tambig_reads\ttotal_reads\n"
        b"0\t3\t3\n900\t100\t1000\n10\t2\t12\n"
    )


def test_write_single_cell_mtx_vectorized(tmp_path):
    names = ["t1", "t2"]
    rows = np.array([0, 0, 4])
    cols = np.array([0, 1, 1])
    vals = np.array([2.0, 0.25, 17.5])
    out = tmp_path / "sc"
    write_single_cell_output(
        out, {}, names, ["AAA", "CCC"], rows, cols, vals, num_rows=5,
    )
    mtx = (tmp_path / "sc.count.mtx").read_bytes()
    assert mtx == (
        b"%%MatrixMarket matrix coordinate real general\n"
        b"5 2 3\n"
        b"1 1 2\n1 2 0.25\n5 2 17.5\n"
    )
    # empty matrix still writes a valid header
    write_single_cell_output(
        tmp_path / "sc0", {}, names, [], np.array([], np.int64),
        np.array([], np.int64), np.array([]), num_rows=0,
    )
    assert (tmp_path / "sc0.count.mtx").read_bytes() == (
        b"%%MatrixMarket matrix coordinate real general\n0 2 0\n"
    )


@pytest.mark.parametrize("n_reps,n_txps", [(1, 1), (3, 17), (20, 5000)])
def test_infrep_parquet_reads_back_in_pyarrow(tmp_path, n_reps, n_txps):
    """The stdlib Parquet writer: pyarrow reads the replicate columns
    back with their names, nullable float64 type and exact values."""
    pq = pytest.importorskip("pyarrow.parquet")
    from oarfish_tpu.quant.writers import write_infrep_file

    rng = np.random.default_rng(n_txps)
    breps = rng.gamma(2.0, 50.0, size=(n_reps, n_txps))
    breps[:, 0] = 0.0
    write_infrep_file(tmp_path / "o", breps)
    path = tmp_path / "o.infreps.pq"
    t = pq.read_table(path)
    assert t.column_names == [f"bootstrap.{i}" for i in range(n_reps)]
    for i in range(n_reps):
        field = t.schema.field(i)
        assert str(field.type) == "double" and field.nullable
        assert t.column(i).null_count == 0
        np.testing.assert_array_equal(t.column(i).to_numpy(), breps[i])
    meta = pq.ParquetFile(path).metadata
    assert meta.num_rows == n_txps and meta.num_row_groups == 1
    assert meta.row_group(0).column(0).compression == "GZIP"
