"""Unit tests for the compensated (Kahan–Neumaier) accumulation helpers.

These back the tol=1.0 stopping semantics: every model's ELBO and LDA/fLDA's Elogtheta_sum ride a
(hi, lo) pair through the chunk scan, the cross-shard reduction, and —
for El_sum — into the Dirichlet Newton's mean-form gradient
(ops/newton.py, reference update_alpha! LDA.jl:97-118).
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from topicmodelsvb_jl_tpu.ops.newton import dirichlet_newton
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.parallel.shard import shard_map
from topicmodelsvb_jl_tpu.utils.numerics import (
    elbo_value, kbn_add, kbn_merge, kbn_pack, kbn_psum, kbn_zero,
    kbn_zeros,
)


def _f32(x):
    return jnp.asarray(x, jnp.float32)


def test_kbn_add_recovers_lost_low_bits_scalar():
    # 2^25 + 1024 ones: naive f32 addition drops every 1.0 (ulp(2^25)=4)
    base = _f32(2.0**25)
    ones = jnp.ones((1024,), jnp.float32)

    def naive(c, x):
        return c + x, None

    def comp(c, x):
        return kbn_add(c, x), None

    naive_total, _ = jax.lax.scan(naive, base, ones)
    (hi, lo), _ = jax.lax.scan(comp, kbn_add(kbn_zero(jnp.float32), base),
                               ones)
    exact = 2.0**25 + 1024.0
    assert float(naive_total) == 2.0**25          # the failure mode
    assert float(np.float64(hi) + np.float64(lo)) == exact


def test_kbn_add_elementwise_tensor():
    # same property elementwise on a [K] accumulator (the El_sum carry)
    K = 8
    acc = kbn_zeros((K,), jnp.float32)
    acc = kbn_add(acc, jnp.full((K,), 2.0**25, jnp.float32))
    for _ in range(64):
        acc = kbn_add(acc, jnp.ones((K,), jnp.float32))
    got = np.float64(acc[0]) + np.float64(acc[1])
    np.testing.assert_array_equal(got, np.full(K, 2.0**25 + 64.0))


def test_kbn_merge_and_pack_round_trip():
    a = kbn_add(kbn_zero(jnp.float32), _f32(1e8))
    b = kbn_add(kbn_zero(jnp.float32), _f32(3.25))
    packed = kbn_pack(kbn_merge(a, b))
    assert packed.shape == (2,)
    assert elbo_value(packed) == 1e8 + 3.25


def test_kbn_psum_scalar_and_tensor_match_f64():
    """Cross-shard fold on the 8-device mesh equals the f64 reduction
    for shard values whose plain psum rounds at ulp(total)."""
    mesh = make_mesh(axis_names=("data",))
    n = mesh.devices.size
    rng = np.random.default_rng(3)
    his = (rng.uniform(0.9, 1.1, (n, 4)) * 2.0**24).astype(np.float32)
    los = rng.uniform(-1.0, 1.0, (n, 4)).astype(np.float32)

    def f(h, l):
        hi, lo = kbn_psum((h[0], l[0]), ("data",))
        return kbn_pack((hi, lo))

    out = jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=P(None), check_vma=False))(his, los)
    exact = his.astype(np.float64).sum(0) + los.astype(np.float64).sum(0)
    got = np.float64(out[0]) + np.float64(out[1])
    np.testing.assert_allclose(got, exact, rtol=2e-8)  # ≤ f32 ulp of parts

    scal = jax.jit(shard_map(
        lambda h, l: kbn_pack(kbn_psum((h[0, 0], l[0, 0]), ("data",))),
        mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=P(None), check_vma=False))(his[:, :1], los[:, :1])
    exact0 = his[:, 0].astype(np.float64).sum() + los[:, 0].astype(np.float64).sum()
    np.testing.assert_allclose(np.float64(scal).sum(), exact0, rtol=2e-8)


def test_dirichlet_newton_mean_form_matches_scaled_form_f64():
    """The mean-form gradient (ops/newton.py) is algebraically identical
    to the reference's M-scaled form (LDA.jl:104); at f64 the fixpoints
    agree to ~1e-12."""
    rng = np.random.default_rng(11)
    K, M = 25, 4096.0
    alpha0 = jnp.asarray(rng.uniform(0.5, 2.0, K), jnp.float64)
    # plausible Elogtheta_sum: M * E[log theta] under a Dirichlet
    el = np.log(rng.dirichlet(np.full(K, 0.7), 4096)).sum(0)
    el_sum = jnp.asarray(el, jnp.float64)
    a_new = dirichlet_newton(alpha0, el_sum, M, 1000, 1e-12)

    # reference-form oracle (same loop as tests/oracle.py
    # _dirichlet_newton, M-scaled gradient, f64)
    from scipy.special import polygamma, psi
    a = np.asarray(alpha0, np.float64)
    nu = float(K)
    for _ in range(1000):
        rho = 1.0
        grad = nu / a + M * (psi(a.sum()) - psi(a)) + el
        h_inv = -1.0 / (M * polygamma(1, a) + nu / a**2)
        denom = 1.0 / (M * polygamma(1, a.sum())) + h_inv.sum()
        p = (grad - grad @ h_inv / denom) * h_inv
        while np.min(a - rho * p) < 0:
            rho *= 0.5
        a = a - rho * p
        if (rho * np.linalg.norm(grad) < 1e-12) and (nu / K < 1e-12):
            break
        nu *= 0.5
    # (+EPSILON ≈ 1.6e-30 from @positive is far below the tolerance)
    np.testing.assert_allclose(np.asarray(a_new), a, rtol=1e-8)


def test_dirichlet_newton_lo_input_tightens_f32():
    """Feeding the compensation half of a (hi, lo) El_sum brings the f32
    fixpoint closer to the f64 ground truth than dropping it."""
    rng = np.random.default_rng(5)
    K, M = 25, 65536.0
    el64 = np.log(rng.dirichlet(np.full(K, 0.7), 65536)).sum(0)
    alpha0 = np.full(K, 1.0)
    truth = np.asarray(dirichlet_newton(
        jnp.asarray(alpha0, jnp.float64), jnp.asarray(el64, jnp.float64),
        M, 1000, 1e-12))
    # split el64 into an f32 (hi, lo) pair
    hi = el64.astype(np.float32)
    lo = (el64 - hi.astype(np.float64)).astype(np.float32)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    a_plain = np.asarray(dirichlet_newton(
        f32(alpha0), f32(hi), M, 1000, 1e-6), np.float64)
    a_comp = np.asarray(dirichlet_newton(
        f32(alpha0), f32(hi), M, 1000, 1e-6,
        Elogtheta_sum_lo=f32(lo)), np.float64)
    err_plain = np.abs(a_plain - truth).max()
    err_comp = np.abs(a_comp - truth).max()
    assert err_comp <= err_plain * 1.05 + 1e-9
    assert err_comp < 1e-4 * np.abs(truth).max()
