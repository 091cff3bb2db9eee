"""On-device Newton solvers.

* :func:`dirichlet_newton` — the Dirichlet hyperparameter update shared
  by LDA/fLDA: interior-point Newton with log-barrier and back-tracking
  line search (reference LDA.jl:97-118, fLDA.jl:128-149).  The reference
  GPU path runs this on host with a D→H→D round trip every outer
  iteration (gpuLDA.jl:132-154); here it is a replicated on-device
  ``lax.while_loop`` fed by the psum'd Elogtheta_sum, so nothing leaves
  the device.
* :func:`ctm_lambda_newton` — CTM per-document Newton with a K×K SPD
  solve (reference CTM.jl:129-142), batched over documents with the
  matrix-free preconditioned CG of :func:`spd_cg_solve` instead of the
  reference's in-kernel workgroup Gauss–Jordan (``LINSOLVE_c``,
  utils.jl:60-90; the reference's own comment notes pivoting is
  unnecessary for SPD).
* :func:`ctm_vsq_newton` — per-coordinate Newton with back-tracking
  (reference CTM.jl:146-165), vectorised over [B, K].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.numerics import (
    EPSILON, digamma, finite, highest_precision, l2norm, trigamma,
)


def _exp_safe(x: jax.Array) -> jax.Array:
    """Overflow-guarded exp at the CTM Newtons' exp boundary.

    The reference's update_lambda! overflows for large mu (its own
    todo.txt:8/11): a Newton step that jumps lambda toward a huge mu
    leaves exp(lambda + v²/2 − logzeta) unanchored (logzeta is stale
    within the inner loop) and the gradient goes Inf→NaN.  Clamping the
    exponent below the dtype's overflow point (with headroom for the
    C-scaling) is the reference's finite() hygiene (utils.jl) applied
    BEFORE the Inf exists: identical in any sane regime (the clamp only
    binds past e^60 / e^600), huge-but-finite above it, so the Hessian
    stays SPD-finite and the Newton contracts lambda back."""
    hi = jnp.asarray(60.0 if x.dtype == jnp.float32 else 600.0, x.dtype)
    return jnp.exp(jnp.minimum(x, hi))


def _backtrack_rho(x: jax.Array, p: jax.Array, strict: bool) -> jax.Array:
    """Largest ρ = 2^-m with x − ρ·p > 0 (strict) or ≥ 0, elementwise.

    Closed form of the reference's halving loop ``while x - rho*p <= 0:
    rho *= 0.5`` (CTM.jl:154-156, LDA.jl:107-109): the exit value is the
    largest power of two (from 1) below x/p for descending coordinates.
    No inner while_loop — this sits inside viter loops inside the chunk
    scan, where nested data-dependent loops are both slow and fragile.
    """
    ratio = jnp.where(p > 0, x / jnp.where(p > 0, p, 1.0), jnp.inf)
    m = jnp.maximum(jnp.ceil(-jnp.log2(jnp.minimum(ratio, 1.0))), 0.0)
    rho = jnp.exp2(-m)
    if strict:  # need x − ρ·p strictly positive: halve exact ties
        rho = jnp.where(x - rho * p <= 0, rho * 0.5, rho)
    return jnp.where(jnp.isfinite(ratio), rho, jnp.ones_like(rho))


@highest_precision
def spd_cg_solve(matvec, b: jax.Array, inv_diag: jax.Array,
                 active: jax.Array, maxiter: int, rtol: float) -> jax.Array:
    """Matrix-free batched Jacobi-preconditioned CG for SPD systems.

    Replacement for the reference's workgroup Gauss–Jordan
    (``LINSOLVE_c``, utils.jl:60-90) in the CTM lambda Newton: the
    [B, K, K] operator is never materialised — per iteration the only
    non-elementwise work is ``matvec(p)``, which for the CTM neg-Hessian
    Σ⁻¹ + diag(e) is a single [B,K]@[K,K] matmul — so memory traffic is
    O(B·K) per iteration versus the O(B·K²) per elimination step of a
    dense factorisation.  Krylov exactness bounds iterations at K;
    Jacobi preconditioning makes the typical count far smaller.
    Converged/inactive batch lanes freeze (vmap/while semantics).
    The matvec runs at full f32 precision (never TF32): the CG residual
    test and the oracle parity of CTM/fCTM depend on it.
    """
    bnorm2 = jnp.sum(b * b, axis=-1)
    tol2 = (rtol * rtol) * bnorm2
    x = jnp.zeros_like(b)
    r = b
    z = r * inv_diag
    p = z
    rz = jnp.sum(r * z, axis=-1)
    act0 = active & (bnorm2 > 0)

    def cond(c):
        i, _, _, _, _, act = c
        return (i < maxiter) & jnp.any(act)

    def body(c):
        i, x, r, p, rz, act = c
        Ap = matvec(p)
        pAp = jnp.sum(p * Ap, axis=-1)
        alpha = jnp.where(act, rz / jnp.where(pAp > 0, pAp, 1.0), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = r * inv_diag
        rz_new = jnp.sum(r * z, axis=-1)
        beta = rz_new / jnp.where(rz > 0, rz, 1.0)
        p = jnp.where(act[:, None], z + beta[:, None] * p, p)
        act = act & (jnp.sum(r * r, axis=-1) > tol2)
        return i + 1, x, r, p, rz_new, act

    _, x, _, _, _, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(0), x, r, p, rz, act0))
    return x


def spd_solve(A: jax.Array, b: jax.Array) -> jax.Array:
    """Batched SPD solve by Gauss–Jordan elimination without pivoting.

    The twin of the reference's OpenCL ``LINSOLVE_c``
    (utils.jl:60-90) — its own comment notes pivoting is unnecessary for
    SPD systems (utils.jl:56-58).  Implemented with plain HLO ops, so no
    LAPACK-style custom call sits inside the scan/while loops.  A: [B, K, K], b: [B, K] → [B, K].
    """
    K = A.shape[-1]
    M = jnp.concatenate([A, b[..., None]], axis=-1)    # [B, K, K+1]

    def body(j, M):
        piv_row = M[:, j, :] / M[:, j, j][:, None]      # [B, K+1]
        factor = M[:, :, j]                             # [B, K]
        M2 = M - factor[:, :, None] * piv_row[:, None, :]
        return M2.at[:, j, :].set(piv_row)

    M = jax.lax.fori_loop(0, K, body, M)
    return M[:, :, K]


def dirichlet_newton(
    alpha: jax.Array,
    Elogtheta_sum: jax.Array,
    M: jax.Array,
    niter: int,
    ntol: float,
    Elogtheta_sum_lo: jax.Array = None,
) -> jax.Array:
    """Interior-point Newton for the Dirichlet parameter (LDA.jl:97-118).

    The gradient is evaluated in MEAN form — ``M·(nu/(M·alpha) + ψ(Σa)
    − ψ(a_k) + Elogtheta_sum/M)`` — so the near-cancellation at the
    optimum (ψ-difference vs the Elogtheta mean) resolves at the f32
    ulp of O(1) quantities instead of O(M·|Elogtheta|): at corpus scale
    the M-scaled form's absolute rounding (~ulp(6e5) ≈ 0.06) turns into
    an alpha* jitter of relative ~α²·ulp that the bound re-amplifies by
    Elogtheta_sum — an f32 ELBO wobble of 1e3-1e4 per iteration at NSF
    scale, which is why the callers carry Elogtheta_sum as a compensated
    (hi, lo) pair.  ``Elogtheta_sum_lo``
    optionally carries the compensation half of a Kahan-accumulated sum
    (models/lda.py's step carry) into the mean at full precision.
    """
    K = alpha.shape[0]
    dtype = alpha.dtype
    M = jnp.asarray(M, dtype)
    nu0 = jnp.asarray(float(K), dtype)
    el_mean = Elogtheta_sum / M
    if Elogtheta_sum_lo is not None:
        el_mean = el_mean + Elogtheta_sum_lo / M

    def cond(carry):
        i, _, _, done, _ = carry
        return (i < niter) & (~done)

    def body(carry):
        i, alpha, nu, done, prev_norm = carry
        a0 = jnp.sum(alpha)
        grad = M * (nu / (M * alpha) + digamma(a0) - digamma(alpha)
                    + el_mean)
        h_inv = -1.0 / (M * trigamma(alpha) + nu / alpha**2)
        denom = 1.0 / (M * trigamma(a0)) + jnp.sum(h_inv)
        p = (grad - jnp.dot(grad, h_inv) / denom) * h_inv

        # back-tracking: minimum(alpha - rho*p) must stay >= 0 (LDA.jl:107-109).
        # The reference halves rho from 1; the final value is the largest
        # 2^-m with rho <= min_k alpha_k/p_k over descending coordinates —
        # computed here in closed form instead of an inner while_loop.
        ratio = jnp.where(p > 0, alpha / jnp.where(p > 0, p, 1.0), jnp.inf)
        r_star = jnp.min(ratio)
        m = jnp.maximum(jnp.ceil(-jnp.log2(jnp.minimum(r_star, 1.0))), 0.0)
        rho = jnp.exp2(-m)
        # f32 division can round alpha/p up across the power-of-two
        # boundary; validate the actual fp step like the reference's
        # explicit while-condition does and halve once if needed
        rho = jnp.where(jnp.min(alpha - rho * p) < 0, rho * 0.5, rho)

        alpha_new = finite(alpha - rho * p)
        # reference stopping rule (LDA.jl:113-115) — plus, on the f32
        # path only, two numerical stops: once the accepted step is
        # below f32 resolution of alpha, further iterations cannot make
        # progress, and once the barrier has annealed away and steps
        # stop contracting f32 is in a limit cycle.  On f64 — where the
        # reference's tolerances are reachable — only the reference's
        # own rule applies, so a single transiently non-contracting step
        # cannot end the Newton early.
        sn = rho * l2norm(p)
        done_new = done | ((rho * l2norm(grad) < ntol) & (nu / K < ntol))
        if dtype == jnp.float32:
            stagnant = sn <= 1e-6 * (l2norm(alpha) + 1.0)
            cycling = (nu / K < ntol) & (i >= 20) & (sn >= prev_norm)
            done_new = done_new | stagnant | cycling
        # under vmap the while_loop runs until EVERY batch lane is done,
        # so a finished lane must freeze its state (DTM's per-slice vmap)
        alpha_new = jnp.where(done, alpha, alpha_new)
        nu_new = jnp.where(done, nu, nu * 0.5)
        return i + 1, alpha_new, nu_new, done_new, sn

    _, alpha, _, _, _ = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0), alpha, nu0, jnp.asarray(False),
         jnp.asarray(jnp.inf, dtype))
    )
    # @positive model.alpha (LDA.jl:117)
    return alpha + jnp.asarray(EPSILON, dtype)


def ctm_lambda_newton(
    lam: jax.Array,        # [B, K]
    vsq: jax.Array,        # [B, K]
    logzeta: jax.Array,    # [B]
    phi_counts: jax.Array, # [B, K]  = phi @ counts
    C: jax.Array,          # [B]    total token count per doc
    mu: jax.Array,         # [K]
    invsigma: jax.Array,   # [K, K]
    active: jax.Array,     # [B] bool — docs still in their viter loop
    niter: int,
    ntol: float,
) -> jax.Array:
    """Batched CTM lambda Newton (CTM.jl:129-142).

    Per iteration: grad = Σ⁻¹(μ−λ) + φc − C·exp(λ + v²/2 − logζ);
    −H = Σ⁻¹ + C·diag(exp(·)); λ += (−H)⁻¹ grad, via Cholesky
    (SPD: Σ⁻¹ posdef + positive diagonal).  Stops per doc when
    ‖grad‖ < ntol (masked, batch-synchronous).
    """
    dtype = lam.dtype
    K = lam.shape[-1]
    isd = jnp.diagonal(invsigma)
    # CG accuracy: an inexact Newton step only needs a few digits; the
    # f64 oracle path runs CG essentially to machine precision so it
    # matches the reference's exact solve (CTM.jl:139).
    cg_rtol = 1e-5 if dtype == jnp.float32 else 1e-13
    cg_maxiter = K + 8  # Krylov exactness at K, slack for rounding

    def cond(carry):
        i, _, act, _ = carry
        return (i < niter) & jnp.any(act)

    def body(carry):
        i, lam, act, prev_norm = carry
        expo = _exp_safe(lam + 0.5 * vsq - logzeta[:, None]) * C[:, None]  # [B, K]
        grad = (mu - lam) @ invsigma + phi_counts - expo
        # neg hessian: invsigma + diag(expo) (SPD — utils.jl:56-58);
        # solved matrix-free: the matvec is one [B,K]@[K,K] matmul
        # plus an elementwise product, so no [B,K,K] tensor exists
        step = spd_cg_solve(
            lambda x: x @ invsigma + expo * x, grad,
            1.0 / (isd[None, :] + expo), act, cg_maxiter, cg_rtol)
        lam_new = jnp.where(act[:, None], lam + step, lam)
        # reference stop: ‖grad‖ < ntol (CTM.jl:140).  At f32 the noise
        # floor of the C-scaled gradient can exceed ntol forever (the
        # reference runs f64), so two numerical stops are added: step
        # below f32 resolution of lambda, and a limit-cycle detector
        # (steps no longer contracting after the quadratic phase).
        sn = l2norm(step)
        stagnant = sn <= 1e-5 * (l2norm(lam_new) + 1.0)
        cycling = (i >= 8) & (sn >= prev_norm)
        act_new = act & (l2norm(grad) >= ntol) & ~stagnant & ~cycling
        return i + 1, lam_new, act_new, sn

    _, lam, _, _ = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0), lam, active,
         jnp.full(lam.shape[:1], jnp.inf, lam.dtype)))
    return lam.astype(dtype)


def ctm_vsq_newton(
    lam: jax.Array,       # [B, K]
    vsq: jax.Array,       # [B, K]
    logzeta: jax.Array,   # [B]
    C: jax.Array,         # [B]
    invsigma_diag: jax.Array,  # [K]
    active: jax.Array,    # [B] bool
    niter: int,
    ntol: float,
) -> jax.Array:
    """Batched per-coordinate CTM vsq Newton with back-tracking (CTM.jl:146-165)."""
    def cond(carry):
        i, _, act, _ = carry
        return (i < niter) & jnp.any(act)

    def body(carry):
        i, vsq, act, prev_norm = carry
        e = C[:, None] * _exp_safe(lam + 0.5 * vsq - logzeta[:, None])
        grad = -0.5 * (invsigma_diag[None, :] + e - 1.0 / vsq)
        invhess = -1.0 / (0.25 * e + 0.5 / vsq**2)
        p = invhess * grad
        rho = _backtrack_rho(vsq, p, strict=True)
        vsq_new = jnp.where(act, vsq - rho * p, vsq)
        # reference stop (CTM.jl:163) + f32 stagnation/limit-cycle stops
        sn = rho * jnp.abs(p)
        stagnant = sn <= 1e-5 * (jnp.abs(vsq_new) + 1e-12)
        cycling = (i >= 8) & (sn >= prev_norm)
        act_new = act & (rho * jnp.abs(grad) >= ntol) & ~stagnant & ~cycling
        return i + 1, vsq_new, act_new, sn

    act0 = active[:, None] & jnp.ones_like(vsq, dtype=bool)
    _, vsq, _, _ = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0), vsq, act0, jnp.full_like(vsq, jnp.inf)))
    # @positive model.vsq[d] (CTM.jl:164)
    return vsq + jnp.asarray(EPSILON, vsq.dtype)
