"""Numeric utilities and constants.

Re-implementation of the reference's numeric layer
(TopicModelsVB.jl ``src/utils.jl``):

* ``EPSILON`` underflow guard (utils.jl:3) — ``eps(1e-14) ≈ 1.6e-30``.
* ``finite`` overflow clamp (utils.jl:107).
* ``additive_logistic`` overflow-safe softmax (utils.jl:114-139).
* ``logsumexp`` (utils.jl:110).
* Dirichlet entropy closed form (utils.jl:163-180).
* digamma/trigamma — the reference hand-rolls an OpenCL digamma
  (utils.jl:21-53); here f32 digamma/lgamma/log/exp get ~2-ULP
  Cephes-style constructions (see the "accurate float32
  transcendentals" section), while f64 falls through to the XLA
  intrinsics.

Everything here is jit-safe and dtype-polymorphic (f32 on the
accelerator, f64 for the CPU oracle, mirroring the reference's CPU-f64/GPU-f32
split, LDA.jl:14-21 vs gpuLDA.jl:14-21).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Underflow guard: Julia eps(1e-14) (reference utils.jl:3).  Still a normal
# float32 (> 1.18e-38), matching the reference's EPSILON32 = 1e-30 (utils.jl:6).
EPSILON = float(np.spacing(1e-14))  # 1.6033346880071782e-30

# Euler–Mascheroni constant (reference utils.jl:10).
EULERGAMMA = 0.5772156649015329


def highest_precision(fn):
    """Trace ``fn`` with every f32 contraction at full f32 precision.

    On the GPU an f32 dot at default precision may run in TF32, which
    keeps about three decimal digits: enough to move the CTM/fCTM PCG
    solve, the moment updates, the HMTM recurrences and every family's
    ``phi @ counts`` off the f64 oracles.  The step and ELBO builders
    wrap what they return in this scope (never set globally); the
    contractions they hold are batched matvecs and [K, K] products,
    memory- or latency-bound, so full precision costs them nothing
    measurable.
    """
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


def finite(x: jax.Array) -> jax.Array:
    """Clamp ±Inf overflow to ±floatmax (reference utils.jl:107)."""
    fmax = jnp.finfo(x.dtype).max
    return jnp.sign(x) * jnp.minimum(jnp.abs(x), fmax)


def boink(x: jax.Array) -> jax.Array:
    """``x .+ EPSILON`` — the reference's @boink guard (macros.jl:28-31)."""
    return x + jnp.asarray(EPSILON, dtype=x.dtype)


def additive_logistic(x: jax.Array, axis: int | None = None) -> jax.Array:
    """Overflow-safe softmax (reference utils.jl:114-139).

    With ``axis=None`` the max/sum run over the whole array (the
    vector/matrix forms at utils.jl:125-139); otherwise over ``axis``
    (the ``dims`` form at utils.jl:114-121).
    """
    m = jnp.max(x, axis=axis, keepdims=axis is not None)
    e = jnp.exp(x - m)
    return e / jnp.sum(e, axis=axis, keepdims=axis is not None)


def logsumexp(x: jax.Array, axis: int | None = None) -> jax.Array:
    """Overflow-safe log-sum-exp (reference utils.jl:110)."""
    m = jnp.max(x, axis=axis, keepdims=axis is not None)
    out = jnp.log(jnp.sum(jnp.exp(x - m), axis=axis, keepdims=axis is not None)) + m
    return out if axis is None else jnp.squeeze(out, axis=axis)


# ── accurate float32 transcendentals ──────────────────────────────────
#
# A backend whose fast f32 log/exp/lgamma are hundreds of ULPs off puts
# several *units* of error into a corpus ELBO (summed over thousands of
# per-token/per-doc terms) — enough to swamp the true ∆ELBO near
# convergence.  The implementations below are classic Cephes-style
# constructions in pure IEEE f32 arithmetic (~2-3 ULP) that do not
# depend on the backend's intrinsics.  Whether XLA's GPU intrinsics
# make them unnecessary is not yet measured (ROADMAP 3.4).  f64 inputs
# fall through to the XLA intrinsics, which are accurate at that width
# — so the CPU oracle paths are bit-for-bit unchanged.

_LOG2E = 1.4426950408889634
# ln2 = C1 + C2 with C1's low mantissa bits zero, so n*C1 is exact
# for the |n| < 2^15 this code ever sees (Cephes expf/logf split).
_LN2_C1 = 0.693359375
_LN2_C2 = -2.12194440e-4
_HALF_LN2PI = 0.9189385332046727  # ½·ln(2π)


def _alog_f32(x: jax.Array) -> jax.Array:
    """~2-ULP f32 natural log for x > 0 (0 → −inf, <0 → nan)."""
    m, e = jnp.frexp(x)                      # x = m·2^e, m ∈ [0.5, 1)
    c = m < 0.7071067811865476
    m = jnp.where(c, m + m, m)               # m ∈ [√½, √2)
    e = (e - c.astype(e.dtype)).astype(x.dtype)
    r = (m - 1.0) / (m + 1.0)                # |r| ≤ 0.1716
    r2 = r * r
    # log m = 2·atanh(r); truncation < 1.7e-11 ≪ f32 eps
    p = 1 / 3 + r2 * (1 / 5 + r2 * (1 / 7 + r2 * (1 / 9 + r2 * (1 / 11))))
    logm = 2.0 * r + (2.0 * r) * (r2 * p)    # keep the leading 2r exact
    out = (logm + e * _LN2_C2) + e * _LN2_C1
    out = jnp.where(x > 0, out, jnp.where(x == 0, -jnp.inf, jnp.nan))
    return jnp.where(jnp.isposinf(x), jnp.inf, out)


def _aexp_f32(x: jax.Array) -> jax.Array:
    """~2-ULP f32 exp (Cephes argument reduction + degree-7 Taylor)."""
    n = jnp.round(x * _LOG2E)
    n = jnp.clip(n, -150.0, 128.0)           # ldexp-safe; exp saturates anyway
    r = (x - n * _LN2_C1) - n * _LN2_C2      # |r| ≤ ½·ln2 + eps
    p = 1 / 720 + r * (1 / 5040)
    p = 1 / 120 + r * p
    p = 1 / 24 + r * p
    p = 1 / 6 + r * p
    p = 0.5 + r * p
    p = 1.0 + r * (1.0 + r * p)              # 1 + r + r²(½ + …)
    out = jnp.ldexp(p, n.astype(jnp.int32))
    # true f32 boundaries: log(f32_max) ≈ 88.72284, log(min subnormal)
    # ≈ −103.2789 — a looser cutoff would flip finite values to inf/0
    out = jnp.where(x > 88.72284, jnp.inf, out)        # overflow
    return jnp.where(x < -103.279, 0.0, out)           # underflow


def _shift_ge8(x: jax.Array, add):
    """Recurrence push x → y ≥ 8 accumulating ``add(y)`` along the way."""
    y, acc = x, jnp.zeros_like(x)
    for _ in range(8):                       # static unroll; y > 8 once x > 0
        c = y < 8.0
        acc = acc + jnp.where(c, add(y), 0.0)
        y = jnp.where(c, y + 1.0, y)
    return y, acc


def _algamma_f32(x: jax.Array) -> jax.Array:
    """Accurate f32 lnΓ(x) for x > 0: recurrence to y ≥ 8 + Stirling."""
    y, acc = _shift_ge8(x, _alog_f32)        # acc = Σ log(x+i), x+i < 8
    w = 1.0 / y
    w2 = w * w
    series = w * (1 / 12 - w2 * (1 / 360 - w2 * (1 / 1260 - w2 * (1 / 1680))))
    lg = (y - 0.5) * _alog_f32(y) - y + _HALF_LN2PI + series - acc
    return jnp.where(x > 0, lg, jnp.where(x == 0, jnp.inf, jnp.nan))


def _adigamma_f32(x: jax.Array) -> jax.Array:
    """Accurate f32 ψ(x) for x > 0: recurrence to y ≥ 8 + asymptotic."""
    y, acc = _shift_ge8(x, lambda v: 1.0 / v)
    w = 1.0 / y
    w2 = w * w
    psi = (_alog_f32(y) - 0.5 * w
           - w2 * (1 / 12 - w2 * (1 / 120 - w2 * (1 / 252 - w2 * (1 / 240)))))
    return jnp.where(x > 0, psi - acc,
                     jnp.where(x == 0, -jnp.inf, jnp.nan))


def alog(x: jax.Array) -> jax.Array:
    """log with ~2-ULP accuracy at f32 (f64: XLA intrinsic)."""
    x = jnp.asarray(x)
    return _alog_f32(x) if x.dtype == jnp.float32 else jnp.log(x)


def aexp(x: jax.Array) -> jax.Array:
    """exp with ~2-ULP accuracy at f32 (f64: XLA intrinsic)."""
    x = jnp.asarray(x)
    return _aexp_f32(x) if x.dtype == jnp.float32 else jnp.exp(x)


def asoftmax(x: jax.Array, axis: int = -1) -> jax.Array:
    """Max-shifted softmax through :func:`aexp` — the ELBO-path phi
    recompute (the training step keeps the fast intrinsic softmax; the
    *reported bound* is what needs the extra digits)."""
    m = jnp.max(x, axis=axis, keepdims=True)
    e = aexp(x - m)
    return e / jnp.sum(e, axis=axis, keepdims=True)


def digamma(x: jax.Array) -> jax.Array:
    x = jnp.asarray(x)
    return _adigamma_f32(x) if x.dtype == jnp.float32 else jax.lax.digamma(x)


def trigamma(x: jax.Array) -> jax.Array:
    return jax.lax.polygamma(jnp.ones((), dtype=jnp.result_type(x)), x)


def lgamma(x: jax.Array) -> jax.Array:
    x = jnp.asarray(x)
    return _algamma_f32(x) if x.dtype == jnp.float32 else jax.lax.lgamma(x)


def dirichlet_entropy(alpha: jax.Array, axis: int = -1) -> jax.Array:
    """Entropy of Dirichlet(alpha), patched closed form (utils.jl:163-180).

    en = lmnB + (α0 − k)·ψ(α0) − Σⱼ (αⱼ − 1)·ψ(αⱼ),
    lmnB = Σⱼ lnΓ(αⱼ) − lnΓ(α0).
    """
    a0 = jnp.sum(alpha, axis=axis)
    k = alpha.shape[axis]
    lmnb = jnp.sum(lgamma(alpha), axis=axis) - lgamma(a0)
    en = lmnb + (a0 - k) * digamma(a0) - jnp.sum((alpha - 1.0) * digamma(alpha), axis=axis)
    return en


def categorical_entropy(p: jax.Array, axis: int = -1) -> jax.Array:
    """−Σ p log p with 0·log 0 = 0 (reference Elogqz terms, LDA.jl:76-80)."""
    return -jnp.sum(jnp.where(p > 0, p * alog(jnp.where(p > 0, p, 1.0)), 0.0), axis=axis)


def bernoulli_entropy(t: jax.Array) -> jax.Array:
    """Entropy of Bernoulli(t) with 0·log0 = 0 (fLDA Elogqc, fLDA.jl:95-98)."""
    def xlogx(v):
        return jnp.where(v > 0, v * alog(jnp.where(v > 0, v, 1.0)), 0.0)

    return -(xlogx(t) + xlogx(1.0 - t))


def gamma_entropy(shape: jax.Array, rate: jax.Array) -> jax.Array:
    """Entropy of Gamma(shape, scale=1/rate) (CTPF Elogq* terms, CTPF.jl:198-231).

    H = shape − log(rate) + lnΓ(shape) + (1 − shape)·ψ(shape).
    """
    return shape - alog(rate) + lgamma(shape) + (1.0 - shape) * digamma(shape)


def mvnormal_diag_entropy(vsq: jax.Array, axis: int = -1) -> jax.Array:
    """Entropy of N(·, diag(vsq)) (CTM Elogqeta, CTM.jl:76-79).

    H = K/2·(1 + log 2π) + ½·Σ log vsq.
    """
    k = vsq.shape[axis]
    return 0.5 * k * (1.0 + jnp.log(2.0 * jnp.pi)) + 0.5 * jnp.sum(alog(vsq), axis=axis)


def l2norm(x: jax.Array, axis: int = -1) -> jax.Array:
    return jnp.sqrt(jnp.sum(x * x, axis=axis))


def dirichlet_ones(key: jax.Array, n: int, shape: tuple = (),
                   dtype=jnp.float32) -> jax.Array:
    """Dirichlet(1,…,1) rows of width ``n``: normalised iid Exp(1) draws.

    Identical in law to ``jax.random.dirichlet(key, jnp.ones(n), shape)``
    (a flat Dirichlet is normalised iid Gamma(1,1) = Exp(1) variables),
    but one uniform per entry instead of the Marsaglia–Tsang gamma
    rejection sampler, whose per-entry while_loop temporaries make the
    constructor itself fail to compile at large V (K=100, V=2e6 — init
    died in the compiler before any step ran).
    Used by every model constructor (reference init: LDA.jl:33 et al.).
    """
    e = jax.random.exponential(key, tuple(shape) + (n,), dtype)
    return e / jnp.sum(e, axis=-1, keepdims=True)


def masked_fixpoint(body, carry: tuple, viter: int) -> tuple:
    """Early-exiting twin of ``lax.fori_loop(0, viter, body, carry)`` for
    per-lane-masked fixpoints whose carry ENDS with an ``active`` bool mask.

    Every model's E-step runs the reference's per-document viter loop
    batch-synchronously, freezing converged lanes with ``jnp.where`` on
    the mask (the break at e.g. LDA.jl:175, CTM.jl:200, CTPF.jl:359).
    Once every lane's flag clears, further passes are pure no-ops that
    still pay full price (gathers, Newtons, token scans) — so this runs
    the same body under a ``while_loop`` that also stops when
    ``~any(active)``.  Exactly trajectory-neutral by the freezing
    invariant.

    Not reverse-differentiable (while_loop) — fine here: E-step outputs
    enter later gradients only as constants (see models/dtm.py's CG).
    """
    def cond(c):
        i, inner = c
        return (i < viter) & jnp.any(inner[-1])

    def step(c):
        i, inner = c
        return i + 1, body(i, inner)

    _, carry = jax.lax.while_loop(
        cond, step, (jnp.asarray(0, jnp.int32), carry))
    return carry


def is_stochastic(p: np.ndarray, axis: int, atol: float = 1e-6) -> bool:
    """Host-side stochastic-matrix predicate (reference utils.jl:144-154)."""
    p = np.asarray(p)
    return bool(np.all(p >= 0) and np.allclose(p.sum(axis=axis), 1.0, atol=atol))


# ── compensated (Kahan–Neumaier) ELBO accumulation ──
#
# A corpus bound at NSF scale has magnitude ~1.4e8, where the f32 ulp is
# 16 — far above the reference's default stopping tolerance tol=1.0
# (LDA.jl:161).  The reference reaches tol=1.0 only because its CPU path
# is f64.  Three places round at ulp(total): the sequential scan carry
# across chunks, the cross-shard psum, and the final f32 representation
# itself.  All three are fixed by carrying the bound as an UNEVALUATED
# (hi, lo) pair: Neumaier two-sum per chunk partial, gather+fold across
# shards, and host-side f64 combination (``elbo_value``).  Within-chunk
# reductions stay plain f32 — XLA reduces as a tree, whose error at
# chunk scale is O(0.1), below tol.  Tensor math is untouched.

def kbn_zero(dtype) -> tuple:
    """Fresh (hi, lo) compensated accumulator."""
    z = jnp.zeros((), dtype)
    return (z, z)


def kbn_zeros(shape, dtype) -> tuple:
    """Fresh tensor-shaped (hi, lo) compensated accumulator (kbn_add /
    kbn_psum operate elementwise on any shape)."""
    z = jnp.zeros(shape, dtype)
    return (z, z)


def kbn_add(acc: tuple, x: jax.Array) -> tuple:
    """Neumaier two-sum: add scalar ``x`` into the (hi, lo) pair."""
    hi, lo = acc
    s = hi + x
    e = jnp.where(jnp.abs(hi) >= jnp.abs(x), (hi - s) + x, (x - s) + hi)
    return (s, lo + e)


def kbn_merge(a: tuple, b: tuple) -> tuple:
    """Merge two (hi, lo) pairs into one."""
    return kbn_add((a[0], a[1] + b[1]), b[0])


def kbn_pack(acc: tuple) -> jax.Array:
    """(hi, lo) pair → shape-(2,) array (the ELBO return convention)."""
    return jnp.stack([acc[0], acc[1]])


def kbn_psum(acc: tuple, axes) -> tuple:
    """Compensated cross-shard reduction of an (hi, lo) pair (scalar or
    any tensor shape, reduced elementwise).

    A plain ``psum(hi)`` rounds at ulp(total) per shard; instead the hi
    parts are all_gathered and folded sequentially with two-sum (mesh
    sizes are tiny, so the [n, ...] gather+fold is free).  The lo parts
    are far below ulp(total) and psum exactly enough.
    """
    if not axes:
        return acc
    hi, lo = acc
    hs = jax.lax.all_gather(hi, axes).reshape((-1,) + hi.shape)
    lo_t = jax.lax.psum(lo, axes)

    def body(i, c):
        return kbn_add(c, hs[i])

    return jax.lax.fori_loop(0, hs.shape[0],
                             body, (jnp.zeros_like(hi), lo_t))


def elbo_value(e) -> float:
    """Float64 value of an ELBO — a compensated shape-(2,) (hi, lo) pair,
    or a plain scalar (older checkpoints / oracle paths)."""
    a = np.asarray(e, np.float64)
    return float(a.sum()) if a.ndim else float(a)
