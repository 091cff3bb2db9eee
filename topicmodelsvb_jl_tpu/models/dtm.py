"""Dynamic topic model — Blei/Lafferty DTM by CAVI.

Redesign of the reference's v0.6 dynamic topic model
(``v0.6/src/DTM.jl``, 339 LoC).  The corpus is sliced into T windows of
width ``delta`` by document timestamp (DTM.jl:52-63); topic-word
log-probabilities evolve over slices as a Gaussian state-space model
whose posterior is a variational Kalman smoother over ``betahat``
(updateMbeta!/updateVbeta!, DTM.jl:209-242); documents follow the LDA
E-step against their slice's smoothed ``mbeta`` with a logzeta softmax
bound (updatePhi!/updateLzeta!, DTM.jl:204-309).

Architectural moves (not a translation):

* The forward-filter/backward-smoother recursions become two
  ``lax.scan``s over the T axis with [K, V] elementwise carries — the
  time axis is tiny, the state is wide and elementwise.
* The reference's nonlinear conjugate-gradient update for ``betahat``
  hand-derives T² Jacobian blocks of the smoother (``mgrad``/
  ``mbetagrad``, DTM.jl:247-284).  Here the CG objective (Σ_t Elogpw +
  Elogpbeta as a function of betahat through the smoother, DTM.jl:254)
  is a closed JAX function of small [T, K, V] tensors once the per-slice
  sufficient statistics A[t] = Σ_{d∈S_t} phi·counts (scattered by
  slice·V+term) and w[t] = Σ_{d∈S_t} e^{−lzeta_d}·(phi@counts) are
  accumulated — so the gradient is one ``jax.grad`` through the scan,
  and Polak–Ribière CG with back-tracking (DTM.jl:286-301) runs entirely
  on device.
* Per-slice alpha Newtons (DTM.jl:176-197) are ``vmap``-ed over T around
  the shared Dirichlet solver.

State is a NamedTuple pytree; all update functions are pure.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.newton import dirichlet_newton
from ..ops.segment import count_scatter
from ..utils.numerics import (
    EPSILON, aexp, alog, asoftmax, categorical_entropy, digamma,
    dirichlet_entropy, finite, highest_precision, kbn_add, kbn_merge,
    kbn_pack, kbn_psum, kbn_zero, kbn_zeros, l2norm, lgamma,
    masked_fixpoint,
)


class DTMState(NamedTuple):
    alpha: jax.Array       # [T, K]  per-slice Dirichlet hyperparameter
    betahat: jax.Array     # [T, K, V] variational pseudo-observations
    mbeta: jax.Array       # [T, K, V] smoothed means
    vbeta: jax.Array       # [T, K, V] smoothed variances (betahat-free)
    v_filt: jax.Array      # [T, K, V] filtered variances (for the smoother)
    gamma: jax.Array       # [M_pad, K]
    Elogtheta: jax.Array   # [M_pad, K]
    lzeta: jax.Array       # [M_pad]   per-doc softmax bound variable
    elbo: jax.Array


# fixed hyperparameters (DTM.jl:98-103)
SIGMASQ = 1.0   # state-transition variance
BSQ = 1.0       # pseudo-observation variance
V0 = 1.0        # prior variance
M0 = 0.0        # prior mean


def variance_smoother(T: int, K: int, V: int, dtype=jnp.float32):
    """Filtered + smoothed variances (updateVbeta!, DTM.jl:231-242).

    Independent of betahat — computed once.  Returns (v_filt, vbeta).
    """
    eps = jnp.asarray(EPSILON, dtype)
    ones = jnp.ones((K, V), dtype)

    def fwd(v_prev, _):
        v_t = (BSQ / (v_prev + SIGMASQ + BSQ)) * (v_prev + SIGMASQ) + eps
        return v_t, v_t

    _, v_filt = jax.lax.scan(fwd, V0 * ones, None, length=T)

    def bwd(vb_next, v_t):
        vb = v_t + (v_t / (v_t + SIGMASQ)) ** 2 * (vb_next - v_t - SIGMASQ) + eps
        return vb, vb

    _, vbeta_rev = jax.lax.scan(bwd, v_filt[-1], v_filt[:-1], reverse=True)
    vbeta = jnp.concatenate([vbeta_rev, v_filt[-1:]], axis=0)
    return v_filt, vbeta


def mean_smoother(betahat: jax.Array, v_filt: jax.Array) -> jax.Array:
    """Smoothed means mbeta(betahat) (updateMbeta!, DTM.jl:209-223).

    Forward filter m_t = q·m_{t−1} + (1−q)·betahat_t with
    q = bsq/(v_{t−1}+σ²+bsq), then backward smoothing.  Differentiable —
    the CG gradient flows through both scans.
    """
    T = betahat.shape[0]
    m0 = jnp.full_like(betahat[0], M0)
    v_prev = jnp.concatenate(
        [jnp.full_like(v_filt[:1], V0), v_filt[:-1]], axis=0)

    def fwd(m_prev, xs):
        bh_t, v_pm = xs
        q = BSQ / (v_pm + SIGMASQ + BSQ)
        m_t = q * m_prev + (1.0 - q) * bh_t
        return m_t, m_t

    _, m = jax.lax.scan(fwd, m0, (betahat, v_prev))

    def bwd(mb_next, xs):
        m_t, v_t = xs
        q = SIGMASQ / (v_t + SIGMASQ)
        mb = q * m_t + (1.0 - q) * mb_next
        return mb, mb

    _, mbeta_rev = jax.lax.scan(bwd, m[-1], (m[:-1], v_filt[:-1]),
                                reverse=True)
    return jnp.concatenate([mbeta_rev, m[-1:]], axis=0)


def init(key: jax.Array, packed, K: int, T: int, dtype=jnp.float32,
         betahat0: Optional[np.ndarray] = None,
         alpha0: Optional[np.ndarray] = None,
         gamma0: Optional[np.ndarray] = None) -> DTMState:
    """Constructor state (DTM.jl:89-118); optional warm-start arrays."""
    M_pad, V = packed.M_pad, packed.V
    if betahat0 is None:
        betahat = jax.random.normal(key, (T, K, V), dtype)
    else:
        betahat = jnp.asarray(betahat0, dtype)
    alpha = (jnp.ones((T, K), dtype) if alpha0 is None
             else jnp.asarray(alpha0, dtype))
    gamma = (jnp.ones((M_pad, K), dtype) if gamma0 is None
             else jnp.asarray(gamma0, dtype))
    v_filt, vbeta = variance_smoother(T, K, V, dtype)
    mbeta = mean_smoother(betahat, v_filt)
    el = digamma(gamma) - digamma(jnp.sum(gamma, -1, keepdims=True))
    return DTMState(
        alpha=alpha, betahat=betahat, mbeta=mbeta, vbeta=vbeta,
        v_filt=v_filt, gamma=gamma, Elogtheta=el,
        lzeta=jnp.ones((M_pad,), dtype), elbo=jnp.zeros((2,), dtype),
    )


def _phi(mbeta_d, decay, El, softmax=jax.nn.softmax):
    """phi ∝ softmax_K(mbeta[t][:,terms] − decay_k + Elogtheta)
    (updatePhi!, DTM.jl:204-207); decay = e^{maxl−lzeta}·Σ_v e^{x−maxl}."""
    return softmax(mbeta_d - decay[:, None, :] + El[:, None, :], axis=-1)


@highest_precision
def _estep_chunk(mbeta_flat, alpha, rowsum_ovfl, maxl,
                 slice_id, terms, counts, doc_mask,
                 gamma, El, lzeta, viter, vtol, V):
    """Per-chunk E-step fixpoint (train! inner loop, DTM.jl:317-328).

    mbeta_flat: [T·V, K] (slice-major) so one gather serves every doc's
    slice; rowsum_ovfl/maxl: per-slice [T, K]/[T] overflow-safe pieces of
    Σ_v exp(mbeta + vbeta/2) (DTM.jl:225-228).
    """
    eps = jnp.asarray(EPSILON, gamma.dtype)
    flat_idx = slice_id[:, None] * V + terms
    mbeta_d = mbeta_flat[flat_idx]                   # [B, L, K]
    rs_d = rowsum_ovfl[slice_id]                     # [B, K]
    maxl_d = maxl[slice_id]                          # [B]
    alpha_d = alpha[slice_id]                        # [B, K]
    active0 = doc_mask > 0

    def body(_, carry):
        gamma, El, lzeta, active = carry
        decay = jnp.exp(maxl_d - lzeta)[:, None] * rs_d          # [B, K]
        p = _phi(mbeta_d, decay, El)
        pc = jnp.einsum("bl,blk->bk", counts, p,
                        preferred_element_type=gamma.dtype)
        # updateGamma! (DTM.jl:199-202)
        gamma_new = alpha_d + pc + eps
        El_new = digamma(gamma_new) - digamma(
            jnp.sum(gamma_new, -1, keepdims=True))
        # updateLzeta! (DTM.jl:306-309)
        lzeta_new = maxl_d + jnp.log(jnp.sum(pc * rs_d, -1) + eps)
        upd = active[:, None]
        gamma2 = jnp.where(upd, gamma_new, gamma)
        El2 = jnp.where(upd, El_new, El)
        lzeta2 = jnp.where(active, lzeta_new, lzeta)
        # break: ‖Δgamma‖ < vtol (DTM.jl:324)
        active2 = active & (l2norm(gamma2 - gamma) >= vtol)
        return gamma2, El2, lzeta2, active2

    gamma, El, lzeta, _ = masked_fixpoint(
        body, (gamma, El, lzeta, active0), viter)

    # sufficient stats with the final phi
    decay = jnp.exp(maxl_d - lzeta)[:, None] * rs_d
    p = _phi(mbeta_d, decay, El)
    w = p * counts[..., None]
    pc = jnp.sum(w, axis=1)                                   # [B, K]
    # A[t·V + v, k] = Σ phi·counts  (per-slice Elogpw linear term)
    A = count_scatter(w.reshape(-1, w.shape[-1]), flat_idx.reshape(-1),
                      mbeta_flat.shape[0])
    # wz[t, k] = Σ_{d∈S_t} e^{−lzeta_d}·(phi@counts)_k  (exp term weight)
    wz_rows = jnp.exp(-lzeta)[:, None] * pc * doc_mask[:, None]
    wz = count_scatter(wz_rows, slice_id, maxl.shape[0])
    # per-slice Elogtheta sums + doc counts (alpha Newton inputs)
    els = count_scatter(El * doc_mask[:, None], slice_id, maxl.shape[0])
    nd = count_scatter(doc_mask[:, None], slice_id, maxl.shape[0])[:, 0]
    return gamma, El, lzeta, A, wz, els, nd


def cg_objective(betahat, v_filt, vbeta, A, wz):
    """Σ_t Elogpw + Elogpbeta as a function of betahat (calcstep,
    DTM.jl:254), with phi/lzeta frozen in the sufficient statistics.

    Every term is a sum over the vocab axis, so under TP (the [T, K, V]
    tensors sharded on V) this returns the LOCAL contribution and the
    caller psums the value — crucially, no collective sits inside the
    differentiated function (under shard_map with replication checking
    off, psum's transpose is psum, which would rescale the gradient).
    """
    T, K, V = betahat.shape
    mbeta = mean_smoother(betahat, v_filt)
    # Elogpw linear + exp terms (DTM.jl:139-143), constants dropped
    lin = jnp.sum(A.reshape(T, V, K) * jnp.transpose(mbeta, (0, 2, 1)))
    rowsum = jnp.sum(jnp.exp(mbeta + 0.5 * vbeta), axis=2)   # [T, K]
    expterm = jnp.sum(wz * rowsum)
    # Elogpbeta (DTM.jl:119-126), vbeta terms constant — dropped.  The
    # t=1 anchor is the SMOOTHED time-0 mean mbeta0 = q·m0 + (1−q)·mbeta[1]
    # with q = σ²/(v0+σ²) (updateMbeta!, DTM.jl:222-223), not the raw m0.
    q0 = SIGMASQ / (V0 + SIGMASQ)
    mbeta0 = q0 * M0 + (1.0 - q0) * mbeta[:1]
    prev = jnp.concatenate([mbeta0, mbeta[:-1]], 0)
    pbeta = -(0.5 / SIGMASQ) * jnp.sum((mbeta - prev) ** 2)
    return lin - expterm + pbeta


def make_global_update(niter: int, ntol: float, cgiter: int, cgtol: float,
                       vocab_axis: Optional[str] = None):
    """The DTM M-step as a standalone function of the accumulated
    sufficient statistics: per-slice alpha Newtons (updateAlpha!,
    DTM.jl:176-197) + the betahat nonlinear Polak–Ribière CG
    (updateBetahat!, DTM.jl:244-304) with the gradient taken by
    ``jax.grad`` through the smoother scans.

    Shared verbatim by the in-memory step (:func:`make_step`) and
    :class:`~..streaming.StreamingDTM`, so the streamed trajectory is
    the in-memory maths by construction.

    Returns ``update(alpha, betahat, v_filt, vbeta, A, wz, els_hi,
    els_lo, nd) -> (alpha_new, betahat_new, mbeta_new)``.
    """

    def update(alpha, betahat, v_filt, vbeta, A, wz, els_hi, els_lo, nd):
        dt = betahat.dtype
        # per-slice alpha Newton (updateAlpha!, DTM.jl:176-197)
        alpha_new = jax.vmap(
            lambda a, e, lo, n: dirichlet_newton(a, e, jnp.maximum(n, 1.0),
                                                 niter, ntol,
                                                 Elogtheta_sum_lo=lo)
        )(alpha, els_hi, els_lo, nd)

        # betahat nonlinear CG with Polak–Ribière + back-tracking
        # (updateBetahat!, DTM.jl:244-304); gradient via jax.grad
        obj_local = lambda bh: cg_objective(bh, v_filt, vbeta, A, wz)
        # global scalar reductions over the storage axis live OUTSIDE the
        # differentiated function (see cg_objective docstring)
        if vocab_axis is not None:
            gsum = lambda x: jax.lax.psum(x, vocab_axis)
        else:
            gsum = lambda x: x
        obj = lambda bh: gsum(obj_local(bh))
        vg_local = jax.value_and_grad(obj_local)
        vg_fn = lambda bh: (lambda fv_g: (gsum(fv_g[0]), fv_g[1]))(vg_local(bh))

        def cg_body(carry, _):
            bh, p_dir, g_old, rho, f0, done = carry
            f0_new, g = vg_fn(bh)
            f0 = jnp.where(jnp.isfinite(f0), f0, f0_new)  # first iteration
            denom = gsum(jnp.sum(g_old * g_old))
            pr = jnp.clip(gsum(jnp.sum(g * (g - g_old)))
                          / jnp.maximum(denom, 1e-30), 0.0, 1.0)
            p_dir = g + pr * p_dir            # ascent direction
            slope = gsum(jnp.sum(g * p_dir))
            # a momentum-dominated direction can stop ascending; restart
            # from steepest ascent (standard NCG safeguard)
            bad_dir = slope <= 0.0
            p_dir = jnp.where(bad_dir, g, p_dir)
            slope = jnp.where(bad_dir, gsum(jnp.sum(g * g)), slope)

            def ls_body(carry2):
                r, _, it = carry2
                return r * 0.5, obj(bh + r * 0.5 * p_dir), it + 1

            def ls_cond(carry2):
                r, f, it = carry2
                return (f <= f0 + 1e-4 * r * slope) & (it < 10)

            r0 = rho
            f_try = obj(bh + r0 * p_dir)
            r_fin, f_fin, it = jax.lax.while_loop(
                ls_cond, ls_body, (r0, f_try, jnp.asarray(0)))
            # reject the step when back-tracking exhausted without the
            # sufficient-increase condition (keeps CAVI monotone)
            ok = f_fin > f0 + 1e-4 * r_fin * slope
            step_r = jnp.where(ok & ~done, r_fin, 0.0)
            bh_new = bh + step_r * p_dir
            f_acc = jnp.where(ok & ~done, f_fin, f0)
            # cgtol convergence: stop once an ACCEPTED step improves the
            # objective by less than cgtol; a rejected step alone doesn't
            # end CG — the next iteration retries from a smaller rho with
            # a fresh gradient (mirroring the reference's persistent rho,
            # DTM.jl:291-301)
            done_new = done | (ok & (f_acc - f0 < cgtol))
            return (bh_new, p_dir, g, jnp.minimum(r_fin * 2.0, 1.0),
                    f_acc, done_new), None

        g0 = jnp.ones_like(betahat)
        (betahat_new, _, _, _, _, _), _ = jax.lax.scan(
            cg_body,
            (betahat, jnp.zeros_like(betahat), g0,
             jnp.asarray(1.0, dt), jnp.asarray(jnp.inf, dt),
             jnp.asarray(False)),
            None, length=cgiter)
        mbeta_new = mean_smoother(betahat_new, v_filt)
        return alpha_new, betahat_new, mbeta_new

    return highest_precision(update)


def make_step(packed, K: int, T: int, viter: int, vtol: float,
              niter: int, ntol: float, cgiter: int, cgtol: float,
              chunk_docs: int, axis_name=None,
              vocab_axis: Optional[str] = None):
    """One full CAVI sweep (train!, DTM.jl:311-335): per-doc fixpoints,
    per-slice alpha Newtons, then the betahat CG update.

    ``vocab_axis`` shards the [T, K, V] state tensors' V axis (TP): the
    Kalman smoother is elementwise over V so it runs shard-local; the
    E-step gathers mbeta, the CG objective psums its scalar pieces, and
    the A statistic reduce_scatters back to the shard.

    DTM deliberately has **no** ``seq_axis`` (token-axis / SP) mode —
    the only model without one.  Its scaling pressure is the [T, K, V]
    time-sliced parameter state (mac scale: 12·K·15113 floats per
    tensor × 6 tensors), not per-document token streams (mac docs are
    magazine issues, ≤ a few thousand tokens — far below a chip's HBM
    share): token sharding would replicate the dominant [T, K, V]
    smoother work per shard while saving nothing, whereas ``vocab_axis``
    shards exactly the axis that grows.  (SURVEY §5.7b.)
    """
    V = packed.V

    def step(state: DTMState, slice_id, terms, counts, doc_mask):
        M_pad = terms.shape[0]
        B = min(chunk_docs, M_pad)
        n_chunks = M_pad // B
        dt = state.betahat.dtype

        if vocab_axis is not None:
            mbeta_full = jax.lax.all_gather(state.mbeta, vocab_axis,
                                            axis=2, tiled=True)
        else:
            mbeta_full = state.mbeta
        # overflow-safe Σ_v exp(mbeta + vbeta/2) pieces (DTM.jl:225-228);
        # maxl/rowsum must span the FULL vocab
        if vocab_axis is not None:
            x_loc = state.mbeta + 0.5 * state.vbeta
            maxl = jax.lax.pmax(jnp.max(x_loc, axis=(1, 2)), vocab_axis)
            rowsum_ovfl = jax.lax.psum(
                jnp.sum(jnp.exp(x_loc - maxl[:, None, None]), axis=2),
                vocab_axis)
        else:
            x = mbeta_full + 0.5 * state.vbeta                 # [T, K, V]
            maxl = jnp.max(x, axis=(1, 2))                     # [T]
            rowsum_ovfl = jnp.sum(jnp.exp(x - maxl[:, None, None]), axis=2)
        mbeta_flat = jnp.transpose(mbeta_full, (0, 2, 1)).reshape(T * V, K)

        def scan_body(carry, xs):
            A, wz, els, nd = carry
            sid, t, c, dm, g, el, lz = xs
            g2, el2, lz2, Ai, wzi, elsi, ndi = _estep_chunk(
                mbeta_flat, state.alpha, rowsum_ovfl, maxl,
                sid, t, c, dm, g, el, lz, viter, vtol, V)
            return (A + Ai, wz + wzi, kbn_add(els, elsi),
                    nd + ndi), (g2, el2, lz2)

        sh = lambda a: a.reshape((n_chunks, B) + a.shape[1:])
        (A, wz, els, nd), (gamma, El, lzeta) = jax.lax.scan(
            scan_body,
            (jnp.zeros((T * V, K), dt), jnp.zeros((T, K), dt),
             # per-slice Elogtheta sums ride a compensated carry — the
             # alpha-channel fix of models/lda.py, per time slice
             kbn_zeros((T, K), dt), jnp.zeros((T,), dt)),
            (sh(slice_id), sh(terms), sh(counts), sh(doc_mask),
             sh(state.gamma), sh(state.Elogtheta), sh(state.lzeta)),
        )
        unsh = lambda a: a.reshape((M_pad,) + a.shape[2:])
        gamma, El, lzeta = unsh(gamma), unsh(El), unsh(lzeta)

        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name or ())
        if axes:
            wz = jax.lax.psum(wz, axes)
            els = kbn_psum(els, axes)
            nd = jax.lax.psum(nd, axes)
        if vocab_axis is not None:
            # keep only this shard's vocab rows of the A statistic
            A3 = jax.lax.psum_scatter(
                A.reshape(T, V, K), vocab_axis, scatter_dimension=1,
                tiled=True)
            rest = tuple(ax for ax in axes if ax != vocab_axis)
            if rest:
                A3 = jax.lax.psum(A3, rest)
            A = A3.reshape(T * A3.shape[1], K)
        elif axes:
            A = jax.lax.psum(A, axes)

        # M-step: the shared alpha-Newton + betahat-CG update (also the
        # streaming path's global update — identical maths by sharing)
        upd = make_global_update(niter, ntol, cgiter, cgtol,
                                 vocab_axis=vocab_axis)
        alpha_new, betahat_new, mbeta_new = upd(
            state.alpha, state.betahat, state.v_filt, state.vbeta,
            A, wz, els[0], els[1], nd)

        return DTMState(
            alpha=alpha_new, betahat=betahat_new, mbeta=mbeta_new,
            vbeta=state.vbeta, v_filt=state.v_filt,
            gamma=gamma, Elogtheta=El, lzeta=lzeta, elbo=state.elbo,
        )

    return highest_precision(step)


def slice_elbo_terms(state: DTMState) -> jax.Array:
    """The document-independent slice-level bound terms
    Elogpbeta − Elogqbeta (DTM.jl:119-126, 145-148) — split out so the
    streaming path can add them ONCE per sweep while evaluating the
    doc/token terms per batch.  t=1 anchors on the smoothed time-0
    posterior mbeta0/vbeta0 (updateMbeta!/updateVbeta!,
    DTM.jl:222-223, 241)."""
    T, K, V = state.mbeta.shape
    q0 = SIGMASQ / (V0 + SIGMASQ)
    mbeta0 = q0 * M0 + (1.0 - q0) * state.mbeta[:1]
    vbeta0 = V0 + (V0 / (V0 + SIGMASQ)) ** 2 * (
        state.vbeta[:1] - V0 - SIGMASQ)
    prev_m = jnp.concatenate([mbeta0, state.mbeta[:-1]], 0)
    prev_v = jnp.concatenate([vbeta0, state.vbeta[:-1]], 0)
    e_pb = (-0.5 * T * K * V * jnp.log(2 * jnp.pi * SIGMASQ)
            - (0.5 / SIGMASQ) * jnp.sum(
                (state.mbeta - prev_m) ** 2 + state.vbeta + prev_v))
    # +entropy of N(mbeta, vbeta) per coordinate
    e_qb = 0.5 * jnp.sum(alog(2 * jnp.pi * jnp.e * state.vbeta))
    return e_pb + e_qb


def make_elbo(packed, K: int, T: int, chunk_docs: int,
              axis_name: Optional[str] = None,
              include_slice_terms: bool = True):
    """Full ELBO (updateELBO!, DTM.jl:161-174).

    ``include_slice_terms=False`` drops the document-independent
    Elogpbeta − Elogqbeta terms (:func:`slice_elbo_terms`); the
    streaming bound evaluates batches with ``False`` and adds the slice
    terms once."""
    V = packed.V

    def elbo(state: DTMState, slice_id, terms, counts, doc_mask):
        M_pad = terms.shape[0]
        B = min(chunk_docs, M_pad)
        n_chunks = M_pad // B
        dt = state.betahat.dtype
        x = state.mbeta + 0.5 * state.vbeta
        maxl = jnp.max(x, axis=(1, 2))
        rowsum_ovfl = jnp.sum(aexp(x - maxl[:, None, None]), axis=2)
        mbeta_flat = jnp.transpose(state.mbeta, (0, 2, 1)).reshape(T * V, K)
        a = state.alpha

        def scan_body(acc, xs):
            sid, t, c, dm, g, el, lz = xs
            flat_idx = sid[:, None] * V + t
            mbeta_d = mbeta_flat[flat_idx]
            rs_d = rowsum_ovfl[sid]
            maxl_d = maxl[sid]
            decay = aexp(maxl_d - lz)[:, None] * rs_d
            p = _phi(mbeta_d, decay, el, softmax=asoftmax)
            a_d = a[sid]
            # Elogptheta (DTM.jl:128-131)
            e_pt = (finite(lgamma(jnp.sum(a_d, -1)))
                    - jnp.sum(finite(lgamma(a_d)), -1)
                    + jnp.sum((a_d - 1.0) * el, -1))
            pc = jnp.einsum("bl,blk->bk", c, p, preferred_element_type=dt)
            # Elogpz (DTM.jl:133-137)
            e_pz = jnp.sum(pc * el, -1)
            # Elogpw (DTM.jl:139-143)
            e_pw = (jnp.sum(p * mbeta_d * c[..., None], axis=(1, 2))
                    - jnp.sum(pc * rs_d, -1) * aexp(maxl_d - lz)
                    - lz + 1.0)
            # −Elogqtheta, −Elogqz (DTM.jl:150-159)
            e_qt = dirichlet_entropy(g)
            e_qz = jnp.sum(categorical_entropy(p) * c, axis=-1)
            return kbn_add(
                acc, jnp.sum(dm * (e_pt + e_pz + e_pw + e_qt + e_qz))), None

        sh = lambda a_: a_.reshape((n_chunks, B) + a_.shape[1:])
        total, _ = jax.lax.scan(
            scan_body, kbn_zero(dt),
            (sh(slice_id), sh(terms), sh(counts), sh(doc_mask),
             sh(state.gamma), sh(state.Elogtheta), sh(state.lzeta)))

        axes = (axis_name,) if isinstance(axis_name, str) else (
            axis_name if axis_name is not None else ())
        total = kbn_psum(total, axes)
        if include_slice_terms:
            total = kbn_add(total, slice_elbo_terms(state))
        return kbn_pack(total)

    return highest_precision(elbo)


def partition_spec(data_axis="data", vocab_axis: Optional[str] = None):
    from jax.sharding import PartitionSpec as P

    tkv = P(None, None, vocab_axis) if vocab_axis is not None else P()
    return DTMState(
        alpha=P(), betahat=tkv, mbeta=tkv, vbeta=tkv, v_filt=tkv,
        gamma=P(data_axis), Elogtheta=P(data_axis), lzeta=P(data_axis),
        elbo=P(),
    )


def topics_ranking_by_slice(mbeta) -> np.ndarray:
    """Top-terms permutation per (slice, topic) (DTM.jl:336), 1-based."""
    mb = np.asarray(mbeta)
    return np.argsort(-mb, axis=2, kind="stable") + 1
