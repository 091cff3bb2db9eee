"""CI smoke for examples/walkthrough.py: the one
artifact stringing the whole README story together must not rot.

Runs the full 10-section walkthrough as a subprocess on CPU with every
size shrunk via its WALKTHROUGH_* env knobs and asserts it completes.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # ~2 min of small-model compiles on CPU

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_walkthrough_completes():
    env = dict(os.environ)
    env.update(
        WALKTHROUGH_DOCS="200",
        WALKTHROUGH_CITEU_DOCS="200",
        WALKTHROUGH_GEN_DOCS="120",
        WALKTHROUGH_STREAM_DOCS="512",
        WALKTHROUGH_HMTM_DOCS="60",
        WALKTHROUGH_CTPF_K="8",
    )
    # force the CPU backend through jax.config like tests/conftest.py
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "import runpy; "
        f"runpy.run_path({os.path.join(_ROOT, 'examples', 'walkthrough.py')!r}, "
        "run_name='__main__')"
    )
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=_ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"walkthrough failed:\n{r.stderr[-4000:]}"
    assert "walkthrough complete." in r.stdout, r.stdout[-2000:]
