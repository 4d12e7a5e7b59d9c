"""Entry points without CPU fallbacks: the peaks table, the compile
cache, ``bench.py`` and ``chip_smoke.py`` (its phases at tiny size on
the CPU, ``--multi`` on four virtual devices)."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from sparsematrixmultiplicationmpi_jax.bench.harness import (
    PEAKS, device_peaks, roofline_seconds, run_benchmark,
)
from sparsematrixmultiplicationmpi_jax.io.generate import cop20k_like
from sparsematrixmultiplicationmpi_jax.parallel import Auto, make_mesh
from sparsematrixmultiplicationmpi_jax.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_peaks_table_has_h200():
    row = device_peaks("NVIDIA H200")
    assert row["hbm_bytes_per_s"] == 4.8e12
    assert row["f32_flops"] == 67e12
    assert row["tf32_flops"] == 495e12
    assert row["bf16_flops"] == 989e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 80GB HBM3",
                                  "Unknown Accelerator"])
def test_peaks_unknown_kind_raises(kind):
    assert kind not in PEAKS
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)
    with pytest.raises(KeyError):
        roofline_seconds(1000, 100, 100, 8, kind=kind)


def test_roofline_seconds_h200():
    t = roofline_seconds(1000, 100, 100, 8, kind="NVIDIA H200")
    assert t == pytest.approx((1000 * 8 + 1000 * 8 * 4 + 100 * 8 * 4)
                              / 4.8e12)


def test_run_benchmark_cpu_reports_no_roofline():
    csr = cop20k_like(dtype=np.float32, scale=0.005)
    rec = run_benchmark(csr, 4, Auto(), make_mesh(1), warmup=1, iters=1,
                        amortized=True, inner=2)
    assert rec.device_kind == jax.devices()[0].device_kind
    assert rec.roofline_fraction is None
    assert rec.correct


def test_compile_cache_default_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == old  # nothing set


def _run(cmd, cwd, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run(cmd, cwd=cwd, env=full, capture_output=True,
                          text=True, timeout=300)


def test_bench_py_exits_nonzero_on_cpu():
    proc = _run([sys.executable, "bench.py"], ROOT, PYTHONPATH=ROOT)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert "{" not in proc.stdout


def test_chip_smoke_exits_nonzero_on_cpu():
    proc = _run([sys.executable, "chip_smoke.py"], ROOT, PYTHONPATH=ROOT)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository, the script cannot import the
    program and must fail without printing a result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run([sys.executable, "chip_smoke.py"], str(tmp_path),
                PYTHONPATH="")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_device_phase_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        _chip_smoke().phase_device()


@pytest.fixture(scope="module")
def small_cop20k():
    return cop20k_like(dtype=np.float32, scale=0.01)


def test_chip_smoke_bench_and_parity_phases(small_cop20k, capsys):
    cs = _chip_smoke()
    op, times = cs.phase_bench(small_cop20k, inner=2)
    assert set(times) == {"xla", "kernel"}
    assert all(len(t) == 2 for t in times.values())
    cs.phase_parity(small_cop20k, op, ks=(1, 32), inner=2)
    out = capsys.readouterr().out
    assert "[bench] format=WindowedPairs" in out
    assert out.count("[parity]") == 2


def test_chip_smoke_formats_phase(small_cop20k, capsys):
    _chip_smoke().phase_formats(small_cop20k, k=8, inner=2)
    out = capsys.readouterr().out
    for name in ("bucketed_ell", "coo", "bcoo"):
        assert f"format={name}" in out


def test_chip_smoke_contract_phase_f64(capsys):
    assert jax.config.jax_enable_x64  # conftest enables it
    _chip_smoke().phase_contract(cop20k_like(dtype=np.float64, scale=0.005),
                                 k=3)
    out = capsys.readouterr().out
    assert out.count("same=True") == 7


def test_chip_smoke_gcn_phase(capsys):
    _chip_smoke().phase_gcn(n=600)
    assert "[gcn] nodes=600" in capsys.readouterr().out


def test_chip_smoke_multi_phase_on_four_devices(small_cop20k, capsys):
    devices = jax.devices("cpu")[:4]
    _chip_smoke().phase_multi(small_cop20k, devices, ks=(1, 32),
                              gcn_nodes=600)
    out = capsys.readouterr().out
    assert out.count("[multi] ") == 16
    assert "devices=[0, 1, 2, 3]" in out
    assert "[multi_gcn]" in out


def test_chip_smoke_last_line_contract(monkeypatch, capsys):
    """main() ends with exactly the JSON object the driver reads, here
    with every phase stubbed out."""
    cs = _chip_smoke()
    dev = {"platform": "gpu", "kind": "NVIDIA H200", "count": 1}
    monkeypatch.setattr(cs, "phase_device", lambda expect_count=None: dev)
    for name in ("phase_parity", "phase_formats", "phase_gcn",
                 "phase_contract", "phase_multi"):
        monkeypatch.setattr(cs, name, lambda *a, **k: None)
    monkeypatch.setattr(cs, "phase_bench", lambda *a, **k: (None, None))
    monkeypatch.setattr(cache, "enable_compile_cache", lambda: "")
    import sparsematrixmultiplicationmpi_jax.io.generate as gen

    monkeypatch.setattr(gen, "cop20k_like", lambda **kw: None)
    assert cs.main([]) == 0
    assert jax.config.jax_enable_x64  # restored after the f64 phase
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": dev}
