"""Numeric-layer unit tests against SciPy closed forms."""

import numpy as np
import scipy.special as sp
import scipy.stats as st

from topicmodelsvb_jl_tpu.utils import numerics as nx


def test_epsilon_matches_reference():
    # Julia eps(1e-14) (utils.jl:3)
    assert np.isclose(nx.EPSILON, 1.6033346880071782e-30)
    assert np.float32(nx.EPSILON) > 0  # still a normal f32 (EPSILON32 analogue)


def test_additive_logistic():
    x = np.array([[1.0, 2.0, 3.0], [1000.0, 1000.0, 1000.0]])
    out = np.asarray(nx.additive_logistic(x, axis=1))
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-12)
    np.testing.assert_allclose(out[1], [1 / 3] * 3, rtol=1e-12)
    whole = np.asarray(nx.additive_logistic(x))
    np.testing.assert_allclose(whole.sum(), 1.0, rtol=1e-12)


def test_logsumexp():
    x = np.array([1e3, 1e3 + 1.0])
    assert np.isclose(float(nx.logsumexp(x)), sp.logsumexp(x))


def test_dirichlet_entropy():
    a = np.array([0.3, 2.0, 5.5])
    ours = float(nx.dirichlet_entropy(a))
    assert np.isclose(ours, st.dirichlet(a).entropy(), rtol=1e-10)
    # K=1 edge case: reference returns 0 (utils.jl:168-169)
    assert np.isclose(float(nx.dirichlet_entropy(np.array([2.7]))), 0.0, atol=1e-9)


def test_gamma_entropy():
    sh, rate = 2.5, 3.0
    assert np.isclose(
        float(nx.gamma_entropy(np.array(sh), np.array(rate))),
        st.gamma(sh, scale=1 / rate).entropy(), rtol=1e-10,
    )


def test_categorical_bernoulli_entropy():
    p = np.array([0.2, 0.5, 0.3])
    assert np.isclose(float(nx.categorical_entropy(p)), st.entropy(p), rtol=1e-10)
    assert np.isclose(float(nx.categorical_entropy(np.array([1.0, 0.0]))), 0.0)
    assert np.isclose(float(nx.bernoulli_entropy(np.array(0.25))),
                      st.entropy([0.25, 0.75]), rtol=1e-10)
    assert np.isclose(float(nx.bernoulli_entropy(np.array(0.0))), 0.0)


def test_mvnormal_diag_entropy():
    v = np.array([0.5, 2.0, 1.3])
    assert np.isclose(
        float(nx.mvnormal_diag_entropy(v)),
        st.multivariate_normal(np.zeros(3), np.diag(v)).entropy(), rtol=1e-10,
    )


def test_finite_clamps():
    import jax.numpy as jnp

    x = jnp.array([np.inf, -np.inf, 3.0])
    out = np.asarray(nx.finite(x))
    assert np.isfinite(out).all() and out[2] == 3.0 and out[0] > 0 > out[1]


def test_masked_fixpoint_matches_fori_loop():
    """masked_fixpoint == fori_loop for a lane-freezing body, with the
    early exit firing only after every lane's active flag clears."""
    import jax
    import jax.numpy as jnp

    # contraction toward per-lane targets; lanes converge at different
    # iterations, and the body freezes done lanes exactly like the models
    target = jnp.array([1.0, -2.0, 0.5, 3.0])
    vtol = 1e-3

    def body(_, carry):
        x, active = carry
        x_new = x + 0.5 * (target - x)
        x2 = jnp.where(active, x_new, x)
        active2 = active & (jnp.abs(x2 - target) >= vtol)
        return x2, active2

    x0 = jnp.zeros(4)
    a0 = jnp.ones(4, bool)
    viter = 50

    ref_x, ref_a = jax.lax.fori_loop(0, viter, body, (x0, a0))
    got_x, got_a = nx.masked_fixpoint(body, (x0, a0), viter)
    np.testing.assert_array_equal(np.asarray(ref_x), np.asarray(got_x))
    np.testing.assert_array_equal(np.asarray(ref_a), np.asarray(got_a))
    assert not np.asarray(got_a).any()  # all lanes converged well before 50

    # viter smaller than any lane's convergence point: must run all passes
    ref_x5, _ = jax.lax.fori_loop(0, 5, body, (x0, a0))
    got_x5, got_a5 = nx.masked_fixpoint(body, (x0, a0), 5)
    np.testing.assert_array_equal(np.asarray(ref_x5), np.asarray(got_x5))
    assert np.asarray(got_a5).any()

    # body must also work under jit (while_loop tracing)
    jit_x, _ = jax.jit(lambda c: nx.masked_fixpoint(body, c, viter))((x0, a0))
    np.testing.assert_array_equal(np.asarray(ref_x), np.asarray(jit_x))


def test_accurate_f32_transcendentals_vs_scipy():
    """The f32 alog/aexp/algamma/adigamma constructions must stay within
    a few ULPs of the scipy float64 truth.  (They exist because fast
    backend intrinsics can be hundreds of ULPs off; IEEE f32 arithmetic
    is identical on every backend, so this test certifies the
    accelerator behaviour too.)"""
    from scipy.special import digamma as sdigamma
    from scipy.special import gammaln

    import jax
    import jax.numpy as jnp

    eps32 = np.float64(np.finfo(np.float32).eps)
    r = np.random.default_rng(0)
    x = np.concatenate([r.uniform(1e-3, 2, 4000), r.uniform(2, 50, 4000),
                        r.uniform(50, 1e4, 4000), r.uniform(1e4, 1e6, 2000),
                        [1.0, 2.0, 0.5, 7.9999995, 8.0, 1e-3]]).astype(np.float32)
    x64 = x.astype(np.float64)

    got = np.asarray(jax.jit(nx._alog_f32)(jnp.asarray(x)), np.float64)
    want = np.log(x64)
    assert np.max(np.abs(got - want) / (np.maximum(np.abs(want), 1.0) * eps32)) < 2.0

    xe = np.concatenate([r.uniform(-87, 87, 20000), [0.0]]).astype(np.float32)
    got = np.asarray(jax.jit(nx._aexp_f32)(jnp.asarray(xe)), np.float64)
    want = np.exp(xe.astype(np.float64))
    assert np.max(np.abs(got - want) / (want * eps32)) < 2.0
    assert float(nx._aexp_f32(jnp.float32(0.0))) == 1.0
    assert float(nx._aexp_f32(jnp.float32(200.0))) == np.inf
    assert float(nx._aexp_f32(jnp.float32(-200.0))) == 0.0

    got = np.asarray(jax.jit(nx._algamma_f32)(jnp.asarray(x)), np.float64)
    want = gammaln(x64)
    # abs floor covers the recurrence cancellation below x=8 (~9·ulp(9));
    # the relative term covers Stirling rounding at large x
    assert np.max(np.abs(got - want) - (1.2e-5 + 5e-7 * np.abs(want))) < 0

    got = np.asarray(jax.jit(nx._adigamma_f32)(jnp.asarray(x)), np.float64)
    want = sdigamma(x64)
    assert np.max(np.abs(got - want) - (2e-6 + 5e-7 * np.abs(want))) < 0


def test_accurate_f32_edges_and_f64_passthrough():
    import jax
    import jax.numpy as jnp

    assert float(nx._alog_f32(jnp.float32(1.0))) == 0.0
    assert float(nx._alog_f32(jnp.float32(0.0))) == -np.inf
    assert np.isnan(float(nx._alog_f32(jnp.float32(-1.0))))
    assert float(nx._algamma_f32(jnp.float32(0.0))) == np.inf
    assert np.isnan(float(nx._algamma_f32(jnp.float32(-0.5))))
    assert float(nx._adigamma_f32(jnp.float32(0.0))) == -np.inf
    # powers of two go through the e·ln2 path exactly
    for k in (-10, -1, 1, 20):
        got = float(nx._alog_f32(jnp.float32(2.0 ** k)))
        np.testing.assert_allclose(got, k * np.log(2.0), rtol=3e-7)

    # f64 inputs must fall through to the XLA intrinsics bit-for-bit
    x = jnp.asarray(np.random.default_rng(1).uniform(0.01, 500, 100))
    assert x.dtype == jnp.float64
    np.testing.assert_array_equal(np.asarray(nx.lgamma(x)),
                                  np.asarray(jax.lax.lgamma(x)))
    np.testing.assert_array_equal(np.asarray(nx.digamma(x)),
                                  np.asarray(jax.lax.digamma(x)))
    np.testing.assert_array_equal(np.asarray(nx.alog(x)), np.asarray(jnp.log(x)))
    np.testing.assert_array_equal(np.asarray(nx.aexp(x)), np.asarray(jnp.exp(x)))


def test_asoftmax_matches_softmax():
    import jax
    import jax.numpy as jnp

    r = np.random.default_rng(2)
    x = jnp.asarray(r.normal(0, 5, (64, 17)).astype(np.float32))
    got = np.asarray(nx.asoftmax(x), np.float64)
    want = jax.nn.softmax(jnp.asarray(np.asarray(x), np.float64), axis=-1)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-7)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


def test_aexp_f32_overflow_boundaries():
    """aexp must agree with f32 exp semantics AT the boundaries: finite
    for x just below log(f32_max) ~ 88.7228, inf just above; nonzero for
    x above log(min subnormal) ~ -103.279 (regression: an 88.72 cutoff
    flipped finite values in (88.72, 88.7228] to inf)."""
    import jax.numpy as jnp

    for x in (88.72, 88.722, 88.7228):
        got = float(nx.aexp(jnp.float32(x)))
        assert np.isfinite(got) and got > 3e38 * (x > 88.7), x
    assert np.isinf(float(nx.aexp(jnp.float32(88.7229))))
    # below the normal range the platform flushes subnormals to zero
    # (jnp.exp does too) — require agreement with jnp.exp, not a value
    for x in (-87.0, -100.0, -103.2, -104.0):
        assert float(nx.aexp(jnp.float32(x))) == float(jnp.exp(jnp.float32(x))), x
    # relative accuracy holds right up to the overflow edge
    for x in (88.0, 88.7, 88.72, 88.7228):
        want = float(np.exp(np.float64(np.float32(x))))  # post-quantization truth
        got = float(nx.aexp(jnp.float32(x)))
        assert abs(got - want) / want < 1e-6, x
