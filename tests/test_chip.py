"""Tests that need the card: the fused E-step compiled through Triton
(no interpret mode) against the XLA body.  They skip on the CPU; on the
card run ``TMVB_TEST_PLATFORM=gpu python -m pytest -m chip tests/``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topicmodelsvb_jl_tpu.models import lda as lda_mod


@pytest.mark.chip
@pytest.mark.parametrize("L", [88, 256])
def test_compiled_lda_estep_matches_xla(gpu, L):
    import chip_smoke

    K = 100
    packed = chip_smoke.dense_packed(512, 25_319, L)
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask),
            jnp.asarray(float(packed.M), jnp.float32))
    kw = dict(viter=10, vtol=1.0 / K**2, niter=1000, ntol=1.0 / K**2,
              chunk_docs=512, axis_name=None)
    state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float32)
    sx = jax.jit(lda_mod.make_step(packed, K, use_pallas=False, **kw))
    sk = jax.jit(lda_mod.make_step(packed, K, use_pallas=True, **kw))
    a, b = state, state
    for _ in range(2):
        a, b = sx(a, *data), sk(b, *data)
    np.testing.assert_allclose(np.asarray(b.beta), np.asarray(a.beta),
                               rtol=chip_smoke.PARITY_RTOL,
                               atol=chip_smoke.PARITY_ATOL)
