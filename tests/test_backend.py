"""Platform probe and per-platform kernel choice (``utils/backend.py``,
``ops/windowed.py::spmm_windowed_core``, the distributed
``_local_windowed``). The GPU is simulated by patching the probe; the
kernel itself is not run here except through the interpreter."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sparsematrixmultiplicationmpi_jax.ops.pallas_windowed as pw
import sparsematrixmultiplicationmpi_jax.utils.backend as backend
from sparsematrixmultiplicationmpi_jax.formats.windowed import WindowedPairs
from sparsematrixmultiplicationmpi_jax.io.generate import (
    fem3d_csr, generate_fat_vector,
)
from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_jax.ops.windowed import spmm_windowed_core


def test_platform_is_cpu_here():
    assert backend.platform() == "cpu"


def test_platform_probe_failure_raises(monkeypatch):
    def broken():
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError, match="cuda"):
        backend.platform()


@pytest.mark.parametrize("name", ["METAL", "rocm", "neuron"])
def test_platform_unsupported_raises(monkeypatch, name):
    monkeypatch.setattr(
        jax, "devices", lambda: [types.SimpleNamespace(platform=name)])
    with pytest.raises(RuntimeError, match="unsupported"):
        backend.platform()


def test_platform_gpu_passes(monkeypatch):
    monkeypatch.setattr(
        jax, "devices", lambda: [types.SimpleNamespace(platform="gpu")])
    assert backend.platform() == "gpu"


def _wp(R, dtype=np.float32):
    csr = fem3d_csr(600, 9000, seed=1).astype(dtype)
    wp = WindowedPairs.from_csr(csr, block_rows=R, chunk_cols=128,
                                beat_gather_margin=1e9, max_inflation=1e9)
    assert wp is not None
    return csr, wp


def _spy(monkeypatch, plat):
    """Pretend to run on ``plat`` and record kernel calls instead of
    running them (the compiled kernel needs a GPU)."""
    calls = []
    monkeypatch.setattr(backend, "platform", lambda: plat)

    def fake(wp, v_p, *, interpret=False, **kw):
        calls.append(interpret)
        return jnp.zeros_like(v_p)

    monkeypatch.setattr(pw, "spmm_windowed_pallas", fake)
    return calls


@pytest.mark.parametrize("plat,R,dtype,use_pallas,expect", [
    ("gpu", 32, np.float32, None, [False]),     # auto: compiled kernel
    ("gpu", 32, "bfloat16", None, [False]),
    ("gpu", 8, np.float32, None, []),           # R < 16: XLA path
    ("gpu", 32, np.float64, None, []),          # f64: XLA path
    ("gpu", 32, np.float32, False, []),         # forced XLA
    ("gpu", 32, np.float32, True, [False]),     # explicit: never interpret
    ("cpu", 32, np.float32, None, []),          # CPU auto: XLA path
    ("cpu", 32, np.float32, True, [True]),      # CPU explicit: interpreter
])
def test_core_kernel_choice_per_platform(monkeypatch, plat, R, dtype,
                                         use_pallas, expect):
    dt = jnp.bfloat16 if dtype == "bfloat16" else dtype
    _, wp = _wp(R, dt)
    calls = _spy(monkeypatch, plat)
    v_p = wp.encode(jnp.ones((wp.shape[1], 4), dt))
    spmm_windowed_core(wp, v_p, use_pallas=use_pallas)
    assert calls == expect


@pytest.mark.parametrize("plat,kernel,expect", [
    ("gpu", "auto", False), ("gpu", "pallas", False), ("gpu", "xla", None),
    ("cpu", "auto", None), ("cpu", "pallas", True), ("cpu", "xla", None),
])
def test_local_windowed_kernel_choice(monkeypatch, plat, kernel, expect):
    """The distributed per-device dispatch: ``expect`` is the interpret
    flag the kernel gets, or None when the einsum path runs."""
    from sparsematrixmultiplicationmpi_jax.parallel import windowed_strategy

    calls = []
    monkeypatch.setattr(backend, "platform", lambda: plat)

    def fake(block_ptr, pair_chunk, tiles, v, *, interpret=False):
        calls.append(interpret)
        return jnp.zeros((tiles.shape[1] * (block_ptr.shape[0] - 1),
                          v.shape[1]), jnp.float32)

    monkeypatch.setattr(pw, "windowed_matmul_pallas", fake)
    R, C, nb = 16, 32, 2
    tiles = jnp.zeros((2, R, C), jnp.float32)
    out = windowed_strategy._local_windowed(
        tiles, jnp.zeros((2,), jnp.int32), jnp.asarray([0, 1], jnp.int32),
        jnp.asarray([[0, 1, 2]], jnp.int32), jnp.zeros((C, 3), jnp.float32),
        nb, R, 3, kernel)
    assert out.shape == (nb * R, 3)
    assert calls == ([] if expect is None else [expect])


@pytest.mark.parametrize("k", [1, 12, 32])
def test_core_explicit_kernel_pads_and_matches_oracle(k):
    """use_pallas=True on the CPU runs the real kernel in the
    interpreter, padding k to the kernel's width and slicing it back."""
    csr, wp = _wp(32)
    v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=2),
                    jnp.float32)
    out = np.asarray(wp.decode(spmm_windowed_core(wp, wp.encode(v),
                                                  use_pallas=True)))
    ref = spmm_host_f64(csr, np.asarray(v))
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
