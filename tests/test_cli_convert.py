"""CLI convert/reorder command tests."""

import numpy as np

from sparsematrixmultiplicationmpi_jax.cli import main as cli_main
from sparsematrixmultiplicationmpi_jax.formats.reorder import (
    apply_symmetric_permutation, bandwidth,
)
from sparsematrixmultiplicationmpi_jax.formats.serialize import load_format
from sparsematrixmultiplicationmpi_jax.io.generate import banded_csr
from sparsematrixmultiplicationmpi_jax.io.mtx import (
    read_matrix_market, write_matrix_market,
)
from sparsematrixmultiplicationmpi_jax import max_abs_error


def test_reorder_command(tmp_path, capsys):
    csr = banded_csr(150, 5, 4, seed=161)
    scrambled = apply_symmetric_permutation(
        csr, np.random.default_rng(162).permutation(150)
    )
    src = str(tmp_path / "in.mtx")
    dst = str(tmp_path / "out.mtx")
    write_matrix_market(src, scrambled)
    assert cli_main(["reorder", src, dst]) == 0
    out = capsys.readouterr().out
    assert "bandwidth" in out
    reordered = read_matrix_market(dst)
    assert bandwidth(reordered) < bandwidth(scrambled)
    assert reordered.nnz == scrambled.nnz


def test_convert_command(tmp_path, capsys):
    csr = banded_csr(100, 4, 3, seed=163)
    src = str(tmp_path / "m.mtx")
    dst = str(tmp_path / "m.npz")
    write_matrix_market(src, csr)
    assert cli_main([
        "convert", src, dst, "--format", "banded", "--block-rows", "8",
        "--dtype", "float64",
    ]) == 0
    obj = load_format(dst)
    assert type(obj).__name__ == "BandedBlocks"
    assert max_abs_error(obj.to_dense(), csr.to_dense()) == 0.0


def test_convert_csr_then_run(tmp_path, capsys):
    csr = banded_csr(60, 3, 2, seed=164)
    src = str(tmp_path / "m.mtx")
    dst = str(tmp_path / "m.npz")
    write_matrix_market(src, csr)
    assert cli_main(["convert", src, dst, "--format", "csr",
                     "--dtype", "float64"]) == 0
    rc = cli_main(["run", dst, "--k", "2", "--strategy", "row",
                   "--iters", "1", "--warmup", "1", "--dtype", "float64"])
    assert rc == 0
    assert "Results are the same!" in capsys.readouterr().out


def test_run_prepared_format(tmp_path, capsys):
    csr = banded_csr(60, 3, 2, seed=165)
    src = str(tmp_path / "m.mtx")
    dst = str(tmp_path / "m.npz")
    write_matrix_market(src, csr)
    cli_main(["convert", src, dst, "--format", "banded", "--block-rows", "8"])
    rc = cli_main(["run", dst, "--k", "2", "--iters", "1", "--warmup", "1",
                   "--dtype", "float64"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "BandedBlocks" in out
    assert "Auto Execution time:" in out
