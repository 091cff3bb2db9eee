"""Hidden Markov topic model — structured VB.

The reference ships HMTM only as an unfinished research stub
(``HMTM/HMTM.jl``): its fully-factorised variational family puts a
*parametric* chain ``q(z_n) = phi^(n-1) lambda`` on the topic sequence
(HMTM.jl:57-87), and the resulting ``phi`` coordinate — full of matrix
powers — was never solved (``updatePhi!`` is an empty function,
HMTM.jl:186-187; see HMTM/HMTMREADME.md).  This module completes the
model by replacing that family with the standard **structured**
variational family for HMMs (Beal 2003, ch. 3): ``q(z_1..z_N)`` is the
*exact* chain posterior under expected-log parameters, computed by
scaled forward–backward.  Every coordinate update is then closed form
and the ELBO is exact for the family — the intractable coordinate
never arises.

Generative model (reference HMTM.jl:18-39; Andrews & Vigliocco 2009):

* ``pi_d ~ Dirichlet(eta)`` — initial-topic distribution, per doc;
* ``theta_d[:, l] ~ Dirichlet(alpha[:, l])`` — column ``l`` of the
  per-document topic-transition matrix;
* ``z_1 ~ Cat(pi_d)``, ``z_n | z_{n-1}=l ~ Cat(theta_d[:, l])``;
* ``w_n | z_n=i ~ Cat(beta[i, :])`` with ``beta`` point-estimated,
  exactly as the reference treats every model's beta.

Variational family and updates:

* ``q(pi_d) = Dir(tau_d)``, ``q(theta_d[:, l]) = Dir(gamma_d[:, l])``,
  and ``q(z)`` the chain with tilde-parameters
  ``log p0 = E[log pi]``, ``log A[i, l] = E[log theta[i, l]]``,
  ``log b_n[i] = log beta[i, w_n]``.
* Forward–backward gives the exact posteriors ``r_n[i] = q(z_n = i)``
  and pairwise ``xi_n[i, l] = q(z_n = i, z_{n-1} = l)``; then
  ``tau = eta + r_1`` (the solved form of updateTau!, HMTM.jl:160-162),
  ``gamma[i, l] = alpha[i, l] + Σ_{n≥2} xi_n[i, l]`` (updateGamma!,
  HMTM.jl:164-166), ``beta[i, j] ∝ Σ_d Σ_n r_n[i]·[w_n = j]``
  (updateBeta!, HMTM.jl:149-158).
* ``eta`` / each column of ``alpha`` get the same interior-point
  Dirichlet Newton the reference uses (updateEta!/updateAlpha!,
  HMTM.jl:103-147), via :func:`~..ops.newton.dirichlet_newton`.  (The
  stub's updateAlpha! anneals with ``trigamma(sum(alpha))`` over the
  whole matrix, HMTM.jl:132 — a bug in unfinished code; the correct
  per-column sum is used here.)
* ELBO: for the structured family
  ``E_q[log p(w, z | ·)] − E_q[log q(z)] = log Z̃_d`` (the forward
  normaliser), so
  ``ELBO = Σ_d log Z̃_d + E[log p(pi)/q(pi)] + E[log p(theta)/q(theta)]``.

Like the reference (which enumerates ``doc.terms`` and ignores
``counts``, HMTM.jl:63-67, 149-155), every entry of a document's terms
vector is one token *in order*; HMTM therefore wants un-``condense``d
corpora.

Device mapping: documents are packed dense ``[B, L]`` and the
per-position recursions run as ``lax.scan`` over the token axis with
batched ``[B,K,K]×[B,K]`` contractions (at full f32 precision, see
utils/numerics.highest_precision).  Token-axis (seq) sharding is
deliberately not offered: the forward recursion is sequential in ``n``,
so a token shard boundary would serialise a cross-device round trip per
position; the long-doc lever here is length-bucketed packing (the model
is bucketed like LDA).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.newton import dirichlet_newton
from ..ops.packing import seg_loc_starts
from ..ops.segment import count_scatter
from ..utils.numerics import (
    EPSILON, aexp, alog, digamma, dirichlet_entropy, dirichlet_ones,
    highest_precision, kbn_add, kbn_pack,
    kbn_psum, kbn_zero, kbn_zeros, l2norm, lgamma, masked_fixpoint,
)


class HMTMState(NamedTuple):
    eta: jax.Array      # [K] Dirichlet prior on pi
    alpha: jax.Array    # [K, K] column l = Dirichlet prior on theta[:, l]
    beta: jax.Array     # [K, V] right-stochastic rows
    tau: jax.Array      # [M_pad, K] q(pi_d)
    gamma: jax.Array    # [M_pad, K, K] q(theta_d), columns are Dirichlets
    elbo: jax.Array     # compensated (hi, lo) bound, shape (2,)


def check_order_preserving(packed) -> None:
    """HMTM consumes terms as an ordered token stream and ignores counts
    (HMTM.jl:63-67); a condensed corpus (any term count > 1) would be
    silently fit with its multiplicity — and its word order — destroyed.
    Every other model consumes counts, so this must fail loudly here."""
    if getattr(packed, "max_count", 0) > 1:
        raise ValueError(
            "HMTM requires an order-preserving corpus (one entry per "
            "token, all counts == 1); this corpus has term counts > 1 — "
            "it was condensed (condense_corp / fixcorp). Re-read the "
            "corpus without condensing to train an HMTM.")


def init(key: jax.Array, packed, K: int, dtype=jnp.float32) -> HMTMState:
    """Constructor state (reference HMTM.jl:26-32)."""
    check_order_preserving(packed)
    M_pad, V = packed.M_pad, packed.V
    beta = dirichlet_ones(key, V, (K,))
    return HMTMState(
        eta=jnp.ones((K,), dtype),
        alpha=jnp.ones((K, K), dtype),
        beta=beta.astype(dtype),
        tau=jnp.ones((M_pad, K), dtype),
        gamma=jnp.ones((M_pad, K, K), dtype),
        elbo=jnp.zeros((2,), dtype),
    )


import os as _os

# Token-axis scan unroll factor (default 1 = plain scan), env-tunable
# for measurement; larger factors have not been measured on the H100.
_SCAN_UNROLL = max(1, int(_os.environ.get("HMTM_SCAN_UNROLL", "1") or 1))


def _tilde(tau: jax.Array, gamma: jax.Array, exp=jnp.exp):
    """Expected-log chain parameters, exponentiated for linear-space FB.

    p0[b,i] = exp ψ(tau)−ψ(Στau); A[b,i,l] = exp ψ(γ_il)−ψ(Σ_i γ_il).
    Both lie in (0, 1] (Jensen), so scaled linear-space recursions are
    overflow-free; underflow is handled by per-step renormalisation.
    """
    Elogpi = digamma(tau) - digamma(jnp.sum(tau, -1, keepdims=True))
    Elogth = digamma(gamma) - digamma(jnp.sum(gamma, -2, keepdims=True))
    return exp(Elogpi), exp(Elogth)


def _forward(p0, A, Bv, tmask, log=jnp.log):
    """Scaled forward pass.

    Bv: [B, L, K] gathered beta[:, w_n] (+EPS); tmask: [B, L] 1 on real
    tokens (trailing padding is 0).  Returns per-position normalised
    messages a [L, B, K], effective scalers c [L, B] (1 on padding) and
    logZ [B] = Σ_n log c_n — the chain's log-normaliser.
    """
    eps = jnp.asarray(EPSILON, p0.dtype)
    m0 = tmask[:, 0][:, None]
    f0 = jnp.where(m0 > 0, p0 * Bv[:, 0], p0)
    c0 = jnp.sum(f0, -1, keepdims=True) + eps
    a0 = f0 / c0
    logZ0 = jnp.where(tmask[:, 0] > 0, log(c0[:, 0]), 0.0)

    def step(carry, xs):
        a_prev, logZ = carry
        B_n, m_n = xs
        f = B_n * jnp.einsum("bil,bl->bi", A, a_prev,
                             preferred_element_type=a_prev.dtype)
        c = jnp.sum(f, -1, keepdims=True) + eps
        a_new = f / c
        upd = (m_n > 0)[:, None]
        a_n = jnp.where(upd, a_new, a_prev)
        c_eff = jnp.where(m_n > 0, c[:, 0], 1.0)
        return (a_n, logZ + log(c_eff)), (a_n, c_eff)

    xs = (jnp.moveaxis(Bv[:, 1:], 1, 0), tmask[:, 1:].T)
    (_, logZ), (a_rest, c_rest) = jax.lax.scan(step, (a0, logZ0), xs,
                                               unroll=_SCAN_UNROLL)
    a = jnp.concatenate([a0[None], a_rest], axis=0)           # [L, B, K]
    c = jnp.concatenate([jnp.where(tmask[:, 0] > 0, c0[:, 0], 1.0)[None],
                         c_rest], axis=0)                     # [L, B]
    return a, c, logZ


def _backward_stats(a, c, A, Bv, tmask, with_r: bool):
    """Scaled backward pass, fused with the statistic accumulations.

    Returns (r0 [B, K], xi_sum [B, K, K], r [B, L, K] or None):
    r_n = q(z_n), xi_sum = Σ_{n≥2} q(z_n, z_{n-1}).  Padded positions
    contribute exact zeros (their be step is the identity).
    """
    B_, L, K = Bv.shape
    dtype = Bv.dtype
    be_last = jnp.ones((B_, K), dtype)
    xi0 = jnp.zeros((B_, K, K), dtype)

    # xi stays an in-carry [B,K,K] accumulator.  Deferring it — xi_sum =
    # A ∘ einsum("nbi,nbl->bil", g, a) after the scan — is algebraically
    # identical but stacks a masked-g [L,B,K] output on every fixpoint
    # pass; which form is faster on the H100 is not measured.
    def step(carry, xs):
        be_n, xi_sum = carry
        a_prev, a_n, B_n, c_n, m_n = xs
        g = (B_n * be_n) / c_n[:, None]               # [B, K]
        upd = (m_n > 0)[:, None]
        xi_n = A * g[:, :, None] * a_prev[:, None, :]  # [B, K, K]
        xi_sum = xi_sum + jnp.where(upd[..., None], xi_n, 0.0)
        r_n = jnp.where(upd, a_n * be_n, 0.0)
        be_prev = jnp.einsum("bil,bi->bl", A, g,
                             preferred_element_type=dtype)
        be_prev = jnp.where(upd, be_prev, be_n)
        return (be_prev, xi_sum), (r_n if with_r else None)

    xs = (a[:-1], a[1:], jnp.moveaxis(Bv[:, 1:], 1, 0),
          c[1:], tmask[:, 1:].T)
    (be0, xi_sum), r_rest = jax.lax.scan(step, (be_last, xi0), xs,
                                         reverse=True, unroll=_SCAN_UNROLL)
    r0 = a[0] * be0 * tmask[:, 0][:, None]
    if not with_r:
        return r0, xi_sum, None
    r = jnp.concatenate([r0[None], r_rest], axis=0)   # [L, B, K]
    return r0, xi_sum, jnp.moveaxis(r, 0, 1)          # [B, L, K]


@highest_precision
def _estep_chunk(betaT_eps, eta, alpha, terms, tmask, doc_mask, tau, gamma,
                 viter, vtol, V):
    """Fused per-chunk E-step: viter chain fixpoint + sufficient stats.

    Mirrors the reference's per-doc viter loop (HMTM.jl:193-205) with
    per-document convergence masking on ‖Δgamma‖_F (HMTM.jl:201);
    returns updated (tau, gamma) plus this chunk's beta_temp [V, K],
    Elogpi_sum [K] and Elogtheta_sum [K, K] Newton statistics.
    """
    Bv = betaT_eps[terms]                             # [B, L, K]
    active0 = doc_mask > 0

    # masked_fixpoint (early-exit while_loop) rather than a fixed
    # fori_loop: each pass costs two full token-axis scans, so once every
    # document in the chunk has hit its ‖Δgamma‖ break (HMTM.jl:201) the
    # remaining viter passes are pure waste — frozen lanes make the early
    # exit exactly trajectory-neutral
    def fp_body(_, carry):
        tau, gamma, active = carry
        p0, A = _tilde(tau, gamma)
        a, c, _ = _forward(p0, A, Bv, tmask)
        r0, xi_sum, _ = _backward_stats(a, c, A, Bv, tmask, with_r=False)
        tau_new = eta[None, :] + r0
        gamma_new = alpha[None, :, :] + xi_sum
        upd = active[:, None]
        delta = l2norm((gamma_new - gamma).reshape(gamma.shape[0], -1))
        tau2 = jnp.where(upd, tau_new, tau)
        gamma2 = jnp.where(upd[..., None], gamma_new, gamma)
        active2 = active & (delta >= vtol)
        return tau2, gamma2, active2

    tau, gamma, _ = masked_fixpoint(fp_body, (tau, gamma, active0), viter)

    # M-step statistics from the chain consistent with the final (tau,
    # gamma) — one extra forward–backward, the structured twin of the
    # reference's stored phi/lambda entering updateBeta! (HMTM.jl:149-158)
    p0, A = _tilde(tau, gamma)
    a, c, _ = _forward(p0, A, Bv, tmask)
    _, _, r = _backward_stats(a, c, A, Bv, tmask, with_r=True)
    K = r.shape[-1]
    beta_temp = count_scatter(r.reshape(-1, K), terms.reshape(-1), V)
    dm = doc_mask[:, None]
    Elogpi = digamma(tau) - digamma(jnp.sum(tau, -1, keepdims=True))
    Elogth = digamma(gamma) - digamma(jnp.sum(gamma, -2, keepdims=True))
    Elogpi_sum = jnp.sum(Elogpi * dm, axis=0)
    Elogth_sum = jnp.sum(Elogth * dm[..., None], axis=0)
    return tau, gamma, beta_temp, Elogpi_sum, Elogth_sum


def make_step(packed, K: int, viter: int, vtol: float, niter: int, ntol: float,
              chunk_docs: int, axis_name=None,
              vocab_axis: Optional[str] = None):
    """Build the jittable outer-iteration step (one full CAVI sweep).

    Control flow mirrors the reference train! (HMTM.jl:189-215): per-doc
    viter fixpoint, then the eta/alpha Newtons and the beta M-step.
    ``axis_name`` psums the sufficient statistics over the data axes;
    ``vocab_axis`` shards beta storage (TP) exactly like the LDA path.
    """
    V = packed.V
    seg_starts = seg_loc_starts(packed)

    def step(state: HMTMState, terms, counts, doc_mask, M_total):
        dtype = state.beta.dtype
        eps = jnp.asarray(EPSILON, dtype)
        if vocab_axis is not None:
            beta_full = jax.lax.all_gather(
                state.beta, vocab_axis, axis=1, tiled=True)
        else:
            beta_full = state.beta
        betaT_eps = beta_full.T + eps                  # [V, K]

        def scan_body(carry, xs):
            beta_temp, pi_sum, th_sum = carry
            t, cnt, dm, tau, gamma = xs
            tmask = (cnt > 0).astype(dtype)
            tau2, gamma2, bt, ps, ts = _estep_chunk(
                betaT_eps, state.eta, state.alpha, t, tmask, dm,
                tau, gamma, viter, vtol, V)
            return (beta_temp + bt, kbn_add(pi_sum, ps),
                    kbn_add(th_sum, ts)), (tau2, gamma2)

        def sweep(t_arr, c_arr, dm_arr, tau_arr, g_arr, carry):
            n_rows = t_arr.shape[0]
            B = min(chunk_docs, n_rows)
            n_chunks = n_rows // B
            sh = lambda a: a.reshape((n_chunks, B) + a.shape[1:])
            carry, (tau, gamma) = jax.lax.scan(
                scan_body, carry,
                (sh(t_arr), sh(c_arr), sh(dm_arr), sh(tau_arr), sh(g_arr)))
            unsh = lambda a: a.reshape((n_rows,) + a.shape[2:])
            return carry, unsh(tau), unsh(gamma)

        # pi/theta stat sums ride compensated (hi, lo) carries — the
        # alpha-channel noise fix of models/lda.py, applied to BOTH of
        # HMTM's Dirichlet Newtons (eta and alpha's K columns)
        carry0 = (jnp.zeros((V, K), dtype), kbn_zeros((K,), dtype),
                  kbn_zeros((K, K), dtype))
        if seg_starts is None:
            (beta_temp, pi_sum, th_sum), tau, gamma = sweep(
                terms, counts, doc_mask, state.tau, state.gamma, carry0)
        else:
            carry = carry0
            tau_parts, g_parts = [], []
            for lo0, t_arr, c_arr, dm_arr in zip(seg_starts, terms, counts,
                                                 doc_mask):
                lo = lo0
                hi = lo + t_arr.shape[0]
                carry, tau2, g2 = sweep(
                    t_arr, c_arr, dm_arr,
                    state.tau[lo:hi], state.gamma[lo:hi], carry)
                tau_parts.append(tau2)
                g_parts.append(g2)
            beta_temp, pi_sum, th_sum = carry
            tau = jnp.concatenate(tau_parts, axis=0)
            gamma = jnp.concatenate(g_parts, axis=0)

        stat_axes = axis_name if axis_name is not None else ()
        if isinstance(stat_axes, str):
            stat_axes = (stat_axes,)
        if stat_axes:
            pi_sum = kbn_psum(pi_sum, stat_axes)
            th_sum = kbn_psum(th_sum, stat_axes)

        # updateBeta! (HMTM.jl:149-158)
        if vocab_axis is not None:
            from ..parallel.shard import tp_normalize_rows

            bt_local, row_sum = tp_normalize_rows(
                beta_temp, vocab_axis, stat_axes + (vocab_axis,))
            beta_new = bt_local.T / row_sum[:, None]
        else:
            if stat_axes:
                beta_temp = jax.lax.psum(beta_temp, stat_axes)
            beta_new = beta_temp.T / jnp.sum(beta_temp.T, 1, keepdims=True)

        # updateEta!/updateAlpha! (HMTM.jl:103-147) — same interior-point
        # Newton as LDA's alpha; alpha's K columns solve independently
        eta_new = dirichlet_newton(state.eta, pi_sum[0], M_total,
                                   niter, ntol, Elogtheta_sum_lo=pi_sum[1])
        alpha_new = jax.vmap(
            lambda a_col, s_col, lo_col: dirichlet_newton(
                a_col, s_col, M_total, niter, ntol,
                Elogtheta_sum_lo=lo_col),
            in_axes=1, out_axes=1)(state.alpha, th_sum[0], th_sum[1])

        return HMTMState(eta=eta_new, alpha=alpha_new, beta=beta_new,
                         tau=tau, gamma=gamma, elbo=state.elbo)

    return highest_precision(step)


def make_elbo(packed, K: int, chunk_docs: int, axis_name=None,
              vocab_axis: Optional[str] = None):
    """Build the jittable full-corpus ELBO.

    For the structured family the z/w terms collapse to the forward
    log-normaliser: ELBO_d = log Z̃_d + E[log p(pi)] − E[log q(pi)]
    + E[log p(theta)] − E[log q(theta)] (Beal 2003, eq. 3.79 analogue;
    the per-term decomposition the stub integrates at HMTM.jl:44-101
    telescopes into exactly this for the exact chain posterior).
    Evaluated with the *current* parameters — the bound after the
    implicit (exact) chain update, so the printed trace is monotone.
    """
    V = packed.V
    seg_starts = seg_loc_starts(packed)

    def elbo(state: HMTMState, terms, counts, doc_mask):
        dtype = state.beta.dtype
        eps = jnp.asarray(EPSILON, dtype)
        if vocab_axis is not None:
            beta_full = jax.lax.all_gather(
                state.beta, vocab_axis, axis=1, tiled=True)
        else:
            beta_full = state.beta
        betaT_eps = beta_full.T + eps
        eta, alpha = state.eta, state.alpha
        # doc-constant Dirichlet normalisers
        pi_const = lgamma(jnp.sum(eta)) - jnp.sum(lgamma(eta))
        th_const = jnp.sum(lgamma(jnp.sum(alpha, 0)) - jnp.sum(lgamma(alpha), 0))

        def scan_body(acc, xs):
            t, cnt, dm, tau, gamma = xs
            tmask = (cnt > 0).astype(dtype)
            p0, A = _tilde(tau, gamma, exp=aexp)
            Bv = betaT_eps[t]
            _, _, logZ = _forward(p0, A, Bv, tmask, log=alog)
            Elogpi = digamma(tau) - digamma(jnp.sum(tau, -1, keepdims=True))
            Elogth = digamma(gamma) - digamma(jnp.sum(gamma, -2, keepdims=True))
            e_ppi = pi_const + jnp.sum((eta - 1.0) * Elogpi, -1)
            e_pth = th_const + jnp.sum((alpha - 1.0) * Elogth, (-2, -1))
            e_qpi = dirichlet_entropy(tau)
            e_qth = jnp.sum(dirichlet_entropy(gamma, axis=-2), -1)
            return kbn_add(
                acc, jnp.sum(dm * (logZ + e_ppi + e_pth + e_qpi + e_qth))), None

        def sweep(t_arr, c_arr, dm_arr, tau_arr, g_arr, acc):
            n_rows = t_arr.shape[0]
            B = min(chunk_docs, n_rows)
            n_chunks = n_rows // B
            sh = lambda a: a.reshape((n_chunks, B) + a.shape[1:])
            acc, _ = jax.lax.scan(
                scan_body, acc,
                (sh(t_arr), sh(c_arr), sh(dm_arr), sh(tau_arr), sh(g_arr)))
            return acc

        acc = kbn_zero(dtype)
        if seg_starts is None:
            acc = sweep(terms, counts, doc_mask, state.tau, state.gamma, acc)
        else:
            for lo0, t_arr, c_arr, dm_arr in zip(seg_starts, terms, counts,
                                                 doc_mask):
                lo = lo0
                hi = lo + t_arr.shape[0]
                acc = sweep(t_arr, c_arr, dm_arr,
                            state.tau[lo:hi], state.gamma[lo:hi], acc)
        axes = axis_name if axis_name is not None else ()
        if isinstance(axes, str):
            axes = (axes,)
        return kbn_pack(kbn_psum(acc, axes))

    return highest_precision(elbo)


def partition_spec(data_axis="data", vocab_axis: Optional[str] = None):
    """shard_map PartitionSpecs: per-doc state sharded, globals replicated."""
    from jax.sharding import PartitionSpec as P

    beta_spec = P(None, vocab_axis) if vocab_axis is not None else P()
    return HMTMState(
        eta=P(), alpha=P(), beta=beta_spec,
        tau=P(data_axis), gamma=P(data_axis), elbo=P(),
    )


def topicdist(state: HMTMState, d=None) -> jax.Array:
    """E_q[pi_d] — the doc's initial/occupancy topic mixture."""
    t = state.tau if d is None else state.tau[d]
    return t / jnp.sum(t, axis=-1, keepdims=True)


def transdist(state: HMTMState, d) -> np.ndarray:
    """E_q[theta_d] — the doc's expected topic-transition matrix
    (columns l sum to 1: p(z_n = · | z_{n-1} = l))."""
    g = np.asarray(state.gamma)[d]
    return g / g.sum(axis=-2, keepdims=True)
