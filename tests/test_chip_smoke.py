"""chip_smoke.py on the CPU: the script refuses to run without a GPU, and
each of its phases runs here at a tiny size (the card runs them at the
bench shapes)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_chip_smoke_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_lda_phase_tiny():
    line = chip_smoke.phase_lda(M=64, K=6, cli_iter=2, api_iter=2)
    assert len(line["elbos"]) == 2 and line["topicdist_row_err"] < 1e-4
    # on the CPU the automatic choice is the XLA body on every segment
    assert {b["body"] for b in line["estep_bodies"]} == {"xla"}
    assert sum(b["rows"] for b in line["estep_bodies"]) >= 64


def test_kernel_parity_phase_tiny():
    line = chip_smoke.phase_kernel_parity(M=16, V=200, K=16, widths=(24,),
                                          steps=2)
    assert line["widths"][0]["dev_over_tol"] <= 1.0


def test_oracle_phase_tiny():
    line = chip_smoke.phase_oracle(M=48, V=120, K=6, L=16)
    assert line["beta_dev_over_tol"] <= 1.0


def test_widest_kernel_width_fits_the_gate():
    from topicmodelsvb_jl_tpu.kernels.lda_estep import choose_estep

    L = chip_smoke.widest_kernel_width(100)
    assert choose_estep(100, L, backend="gpu")
    assert not choose_estep(100, L + 8, backend="gpu")
