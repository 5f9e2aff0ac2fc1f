"""Device and compile-cache setup: no CPU fallback, no Pallas kernels, the
persistent compile cache where JAX_COMPILATION_CACHE_DIR (or else a fixed
path in the checkout) says."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import oarfish_tpu
from oarfish_tpu.cli import DEFAULT_JAX_CACHE_DIR, build_parser

REPO = Path(__file__).resolve().parent.parent
_PRINT_CACHE_DIR = (
    "from oarfish_tpu.cli import enable_persistent_jax_cache;"
    "enable_persistent_jax_cache();"
    "import jax; print(jax.config.jax_compilation_cache_dir)"
)


def _cache_dir_in_subprocess(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "OARFISH_JAX_CACHE")}
    env.update(env_extra)
    r = subprocess.run([sys.executable, "-c", _PRINT_CACHE_DIR], cwd=REPO,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env(tmp_path):
    want = str(tmp_path / "jcache")
    assert _cache_dir_in_subprocess(
        {"JAX_COMPILATION_CACHE_DIR": want}) == want


def test_compile_cache_default_is_fixed_inside_checkout():
    assert DEFAULT_JAX_CACHE_DIR == REPO / ".jax_cache"
    assert _cache_dir_in_subprocess({}) == str(DEFAULT_JAX_CACHE_DIR)
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert ".jax_cache/" in ignored


def test_resolve_em_dtype_raises_instead_of_cpu_fallback(monkeypatch):
    import jax

    from oarfish_tpu.quant import bulk

    def broken_backend():
        raise RuntimeError("Unable to initialize backend 'cuda'")

    before = jax.config.jax_platforms
    monkeypatch.setattr(jax, "default_backend", broken_backend)
    with pytest.raises(RuntimeError, match="Unable to initialize"):
        bulk.resolve_em_dtype("auto")
    assert jax.config.jax_platforms == before


@pytest.mark.parametrize("impl", ["pallas", "v3"])
def test_parser_rejects_removed_em_impls(impl, capsys):
    with pytest.raises(SystemExit):
        build_parser().parse_args(
            ["--alignments", "x.bam", "-o", "out", "--em-impl", impl])
    assert "invalid choice" in capsys.readouterr().err


def test_no_module_uses_pallas():
    pkg = Path(oarfish_tpu.__file__).parent
    offenders = [
        str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
        if "pallas" in p.read_text()
    ]
    assert offenders == []
