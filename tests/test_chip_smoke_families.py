"""chip_smoke.py's phase 2 on the CPU: each of the six non-LDA families
at a tiny size (the card runs them at their bench shapes)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("family", ["flda", "ctm", "fctm", "ctpf", "dtm",
                                    "hmtm"])
def test_family_phase_tiny(family):
    line = chip_smoke.phase_family(family, M=48, K=4, V=200, iters=2)
    assert line["phase"] == family and len(line["elbos"]) == 2
