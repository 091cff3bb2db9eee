"""Filtered correlated topic model — batch-synchronous CAVI.

Redesign of the reference fCTM (``src/fCTM.jl``): CTM plus
fLDA's per-token Bernoulli content/background switch (tau/kappa).
Note two reference quirks mirrored deliberately:

* the viter update order differs from CTM — phi, tau, logzeta,
  **lambda, vsq** (fCTM.jl:250-256; CTM runs vsq before lambda);
* ``update_eta!`` is commented out of the train loop (fCTM.jl:267), so
  eta stays at its 0.5 initialisation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.newton import ctm_lambda_newton, ctm_vsq_newton
from .ctm import _beta_rows
from ..ops.packing import seg_loc_starts
from ..ops.segment import count_scatter
from ..utils.numerics import (
    EPSILON, aexp, alog, asoftmax, bernoulli_entropy, categorical_entropy,
    dirichlet_ones, highest_precision, kbn_add, kbn_merge, kbn_pack,
    kbn_psum, kbn_zero, l2norm, logsumexp, masked_fixpoint,
    mvnormal_diag_entropy,
)


class FCTMState(NamedTuple):
    eta: jax.Array          # scalar (fixed 0.5, fCTM.jl:267)
    mu: jax.Array           # [K]
    sigma: jax.Array        # [K, K]
    invsigma: jax.Array     # [K, K]
    kappa: jax.Array        # [V]
    kappa_old: jax.Array    # [V]
    beta: jax.Array         # [K, V]
    beta_old: jax.Array     # [K, V]
    lam: jax.Array          # [M_pad, K]
    lam_old: jax.Array      # [M_pad, K]
    vsq: jax.Array          # [M_pad, K]
    logzeta: jax.Array      # [M_pad]
    tau: jax.Array          # [M_pad, L]
    tau_old: jax.Array      # [M_pad, L]
    elbo: jax.Array


def init(key: jax.Array, packed, K: int, dtype=jnp.float32) -> FCTMState:
    """Constructor state (reference fCTM.jl:33-64)."""
    M_pad, V, L = packed.M_pad, packed.V, packed.L
    k_beta, k_kappa = jax.random.split(key)
    beta = dirichlet_ones(k_beta, V, (K,)).astype(dtype)
    kappa = dirichlet_ones(k_kappa, V).astype(dtype)
    eye = jnp.eye(K, dtype=dtype)
    eta = jnp.asarray(0.5, dtype)
    tau = jnp.full((M_pad, L), eta, dtype)
    return FCTMState(
        eta=eta, mu=jnp.zeros((K,), dtype), sigma=eye, invsigma=eye,
        kappa=kappa, kappa_old=kappa, beta=beta, beta_old=beta,
        lam=jnp.zeros((M_pad, K), dtype), lam_old=jnp.zeros((M_pad, K), dtype),
        vsq=jnp.ones((M_pad, K), dtype), logzeta=jnp.full((M_pad,), 0.5, dtype),
        tau=tau, tau_old=tau, elbo=jnp.zeros((2,), dtype),
    )


def _phi(logbeta_d, tau, lam, softmax=jax.nn.softmax):
    """phi ∝ exp(tau·log(beta+EPS) + lambda), over K (fCTM.jl:230-233)."""
    return softmax(tau[..., None] * logbeta_d + lam[:, None, :], axis=-1)


@highest_precision
def _estep_chunk(logbetaT, kappa_full, eta, mu, invsigma, terms, counts,
                 doc_mask, lam, lam_old, vsq, logzeta, tau, tau_old,
                 viter, vtol, niter, ntol, V, seq_axis=None):
    """With ``seq_axis`` each document's token axis (and tau) is sharded
    over that mesh axis (SP analogue, SURVEY §5.7b) — see models/ctm.py
    and models/flda.py for the reduction layout."""
    dtype = lam.dtype
    C = jnp.sum(counts, axis=-1)  # per-doc token totals
    if seq_axis is not None:
        C = jax.lax.psum(C, seq_axis)
    eps = jnp.asarray(EPSILON, dtype)
    # ONE combined [V, K+1] gather (see models/flda.py:_estep_chunk)
    K = logbetaT.shape[1]
    tab_d = jnp.concatenate([logbetaT, kappa_full[:, None]], axis=1)[terms]
    logbeta_d = tab_d[..., :K]     # log(beta+EPS) — @boink'd (fCTM.jl:232)
    kappa_d = tab_d[..., K]
    active0 = doc_mask > 0
    isd = jnp.diagonal(invsigma)

    def body(_, carry):
        lam, lam_old, vsq, logzeta, tau, tau_old, active = carry
        # update_phi! (fCTM.jl:230-233)
        p = _phi(logbeta_d, tau, lam)
        # update_tau! (fCTM.jl:221-226)
        s = jnp.sum(p * logbeta_d, axis=-1)
        tau_new = eta / (eta + (1.0 - eta) * kappa_d * jnp.exp(-s) + eps)
        tau_old2 = jnp.where(active[:, None], tau, tau_old)
        tau2 = jnp.where(active[:, None], tau_new, tau)
        # update_logzeta! (fCTM.jl:215-217)
        lz_new = logsumexp(lam + 0.5 * vsq, axis=-1)
        logzeta2 = jnp.where(active, lz_new, logzeta)
        # update_lambda! (fCTM.jl:175-188) — BEFORE vsq, unlike CTM
        pc = jnp.einsum("bl,blk->bk", counts, p, preferred_element_type=dtype)
        if seq_axis is not None:
            pc = jax.lax.psum(pc, seq_axis)
        lam_new = ctm_lambda_newton(lam, vsq, logzeta2, pc, C, mu, invsigma,
                                    active, niter, ntol)
        lam_old2 = jnp.where(active[:, None], lam, lam_old)
        lam2 = jnp.where(active[:, None], lam_new, lam)
        # update_vsq! (fCTM.jl:192-211)
        vsq2 = ctm_vsq_newton(lam2, vsq, logzeta2, C, isd, active, niter, ntol)
        vsq2 = jnp.where(active[:, None], vsq2, vsq)
        active2 = active & (l2norm(lam2 - lam_old2) >= vtol)
        return lam2, lam_old2, vsq2, logzeta2, tau2, tau_old2, active2

    lam, lam_old, vsq, logzeta, tau, tau_old, _ = masked_fixpoint(
        body, (lam, lam_old, vsq, logzeta, tau, tau_old, active0), viter)

    # stats with last phi = f(beta, tau_old, lambda_old); beta weighted by
    # tau·counts (fCTM.jl:168-171), kappa by (1-tau)·counts (fCTM.jl:154-157).
    # ONE fused scatter: both statistics reduce over the same token ids
    # and scatter cost is per-row — kappa rides as an extra lane
    p = _phi(logbeta_d, tau_old, lam_old)
    w_beta = p * (tau * counts)[..., None]
    w_kappa = ((1.0 - tau) * counts)[..., None]
    w_full = jnp.concatenate([w_beta, w_kappa], axis=-1)     # [B, L, K+1]
    stat = count_scatter(w_full.reshape(-1, w_full.shape[-1]),
                         terms.reshape(-1), V)
    beta_temp, kappa_temp = stat[:, :-1], stat[:, -1]
    dm = doc_mask[:, None]
    vsq_sum = jnp.sum(vsq * dm, axis=0)
    lam_sum = jnp.sum(lam * dm, axis=0)
    lam_outer = jnp.einsum("bi,bj->ij", lam * dm, lam)
    return (lam, lam_old, vsq, logzeta, tau, tau_old,
            beta_temp, kappa_temp, vsq_sum, lam_sum, lam_outer)


def make_step(packed, K: int, viter: int, vtol: float, niter: int, ntol: float,
              chunk_docs: int, axis_name=None,
              vocab_axis: Optional[str] = None, seq_axis: Optional[str] = None,
              identify: bool = False):
    """``vocab_axis`` shards beta [K, V] and kappa [V] storage (TP);
    ``seq_axis`` shards the token axis + tau (SP analogue, dense packing
    only).  ``identify=True`` gauge-fixes the Gaussian channel exactly
    like CTM's (models/ctm.py make_step docstring; reference
    todo.txt:25 / issue #14)."""
    V = packed.V
    seg_starts = seg_loc_starts(packed)
    if seq_axis is not None:
        assert seg_starts is None, "token-axis sharding requires dense packing"

    def step(state: FCTMState, terms, counts, doc_mask, M_total):
        dt = state.beta.dtype
        if vocab_axis is not None:
            beta_full = jax.lax.all_gather(state.beta, vocab_axis, axis=1, tiled=True)
            kappa_full_v = jax.lax.all_gather(state.kappa, vocab_axis, axis=0, tiled=True)
        else:
            beta_full, kappa_full_v = state.beta, state.kappa
        logbetaT = jnp.log(beta_full + jnp.asarray(EPSILON, dt)).T

        def scan_body(carry, xs):
            bt, kt, vs, ls, lo = carry
            t, c, dm, la, lao, v, lz, ta, tao = xs
            (la2, lao2, v2, lz2, ta2, tao2,
             bti, kti, vsi, lsi, loi) = _estep_chunk(
                logbetaT, kappa_full_v, state.eta, state.mu, state.invsigma,
                t, c, dm, la, lao, v, lz, ta, tao, viter, vtol, niter, ntol, V,
                seq_axis=seq_axis,
            )
            return ((bt + bti, kt + kti, vs + vsi, ls + lsi, lo + loi),
                    (la2, lao2, v2, lz2, ta2, tao2))

        def sweep(t_a, c_a, dm_a, la_a, lao_a, v_a, lz_a, ta_a, tao_a, carry):
            n_rows = t_a.shape[0]
            B = min(chunk_docs, n_rows)
            n_chunks = n_rows // B
            sh = lambda a: a.reshape((n_chunks, B) + a.shape[1:])
            carry, ys = jax.lax.scan(
                scan_body, carry,
                (sh(t_a), sh(c_a), sh(dm_a), sh(la_a), sh(lao_a),
                 sh(v_a), sh(lz_a), sh(ta_a), sh(tao_a)),
            )
            unsh = lambda a: a.reshape((n_rows,) + a.shape[2:])
            return carry, tuple(unsh(y) for y in ys)

        carry = (jnp.zeros((V, K), dt), jnp.zeros((V,), dt), jnp.zeros((K,), dt),
                 jnp.zeros((K,), dt), jnp.zeros((K, K), dt))
        if seg_starts is None:
            carry, (lam, lam_old, vsq, logzeta, tau, tau_old) = sweep(
                terms, counts, doc_mask, state.lam, state.lam_old,
                state.vsq, state.logzeta, state.tau, state.tau_old, carry)
        else:
            Lmax = state.tau.shape[1]
            parts = []
            for lo0, t_a, c_a, dm_a in zip(seg_starts, terms, counts, doc_mask):
                lo_, hi_ = lo0, lo0 + t_a.shape[0]
                Ls = t_a.shape[1]
                carry, ys = sweep(
                    t_a, c_a, dm_a, state.lam[lo_:hi_], state.lam_old[lo_:hi_],
                    state.vsq[lo_:hi_], state.logzeta[lo_:hi_],
                    state.tau[lo_:hi_, :Ls], state.tau_old[lo_:hi_, :Ls],
                    carry)
                la2, lao2, v2, lz2, ta2, tao2 = ys
                padL = lambda a: jnp.pad(
                    a, ((0, 0), (0, Lmax - Ls)), constant_values=0.5)
                parts.append((la2, lao2, v2, lz2, padL(ta2), padL(tao2)))
            lam, lam_old, vsq, logzeta, tau, tau_old = (
                jnp.concatenate([p_[i] for p_ in parts], axis=0)
                for i in range(6))
        beta_temp, kappa_temp, vsq_sum, lam_sum, lam_outer = carry

        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name or ())
        # token-local stats also reduce over the token shards; doc-level
        # moments are identical across seq shards (data axes only)
        axes_tok = axes + (seq_axis,) if seq_axis is not None else axes
        if axes:
            vsq_sum = jax.lax.psum(vsq_sum, axes)
            lam_sum = jax.lax.psum(lam_sum, axes)
            lam_outer = jax.lax.psum(lam_outer, axes)

        if vocab_axis is not None:
            from ..parallel.shard import tp_normalize_rows

            bt_local, row_sum = tp_normalize_rows(beta_temp, vocab_axis, axes_tok)
            kt_local, k_sum = tp_normalize_rows(
                kappa_temp[:, None], vocab_axis, axes_tok)
            beta_new = _beta_rows(bt_local.T, row_sum[:, None])
            kappa_new = kt_local[:, 0] / k_sum[0]
        else:
            if axes_tok:
                beta_temp = jax.lax.psum(beta_temp, axes_tok)
                kappa_temp = jax.lax.psum(kappa_temp, axes_tok)
            bt = beta_temp.T
            beta_new = _beta_rows(bt, jnp.sum(bt, axis=1, keepdims=True))
            kappa_new = kappa_temp / jnp.sum(kappa_temp)    # fCTM.jl:146-150
        mu_old = state.mu
        centered = (
            lam_outer
            - jnp.outer(mu_old, lam_sum) - jnp.outer(lam_sum, mu_old)
            + M_total * jnp.outer(mu_old, mu_old)
        )
        sigma = (jnp.diag(vsq_sum) + centered) / M_total   # fCTM.jl:140-143
        sigma = 0.5 * (sigma + sigma.T)
        mu_new = lam_sum / M_total                          # fCTM.jl:134-136
        if identify:
            dt = sigma.dtype
            ones_K = jnp.full((K, K), 1.0 / K, dt)
            Pg = jnp.eye(K, dtype=dt) - ones_K
            sigma = Pg @ sigma @ Pg + ones_K
            sigma = 0.5 * (sigma + sigma.T)
            mu_new = mu_new - jnp.mean(mu_new)
        invsigma = jnp.linalg.inv(sigma)
        invsigma = 0.5 * (invsigma + invsigma.T)
        # update_eta! deliberately NOT run (fCTM.jl:267)

        return FCTMState(
            eta=state.eta, mu=mu_new, sigma=sigma, invsigma=invsigma,
            kappa=kappa_new, kappa_old=state.kappa,
            beta=beta_new, beta_old=state.beta,
            lam=lam, lam_old=lam_old, vsq=vsq, logzeta=logzeta,
            tau=tau, tau_old=tau_old, elbo=state.elbo,
        )

    return highest_precision(step)


def make_elbo(packed, K: int, chunk_docs: int, axis_name=None,
              vocab_axis: Optional[str] = None, seq_axis: Optional[str] = None):
    """ELBO (fCTM.jl:67-124): phi from (tau_old, beta_old, lambda_old)."""
    V = packed.V

    seg_starts = seg_loc_starts(packed)
    if seq_axis is not None:
        assert seg_starts is None, "token-axis sharding requires dense packing"

    def elbo(state: FCTMState, terms, counts, doc_mask):
        dt = state.beta.dtype
        eps = jnp.asarray(EPSILON, dt)
        if vocab_axis is not None:
            ag = lambda x, ax: jax.lax.all_gather(x, vocab_axis, axis=ax, tiled=True)
            beta_full, beta_old_full = ag(state.beta, 1), ag(state.beta_old, 1)
            kappa_full = ag(state.kappa, 0)
        else:
            beta_full, beta_old_full = state.beta, state.beta_old
            kappa_full = state.kappa
        logbeta_oldT = alog(beta_old_full + eps).T
        logbetaT = alog(beta_full + eps).T
        logkappa = alog(kappa_full + eps)
        mu, invsigma, eta = state.mu, state.invsigma, state.eta
        chol = jnp.linalg.cholesky(state.invsigma)
        logdet_inv = 2.0 * jnp.sum(alog(jnp.diagonal(chol)))
        log2pi = jnp.log(2.0 * jnp.pi)
        isd = jnp.diagonal(invsigma)
        log_eps = jnp.log(eps)

        # one combined [V, 2K+1] table — the three per-token gathers
        # (logbeta_old, logbeta, logkappa) pay their per-row cost once
        log_tabT = jnp.concatenate(
            [logbeta_oldT, logbetaT, logkappa[:, None]], axis=1)

        def scan_body(acc, xs):
            acc_doc, acc_tok = acc
            t, c, dm, la, lao, v, lz, ta, tao = xs
            lt = log_tabT[t]                             # [B, L, 2K+1]
            cd = jnp.sum(c, axis=-1)
            p = _phi(lt[..., :K], tao, lao, softmax=asoftmax)
            tau_c = jnp.sum(ta * c, -1)
            pc = jnp.einsum("bl,blk->bk", c, p, preferred_element_type=dt)
            if seq_axis is not None:
                # complete the per-doc token reductions across the
                # shards before any nonlinear doc-level term
                cd = jax.lax.psum(cd, seq_axis)
                tau_c = jax.lax.psum(tau_c, seq_axis)
                pc = jax.lax.psum(pc, seq_axis)
            # Elogpeta (fCTM.jl:68-71)
            diff = la - mu
            quad = jnp.einsum("bi,ij,bj->b", diff, invsigma, diff)
            e_peta = 0.5 * (logdet_inv - K * log2pi - jnp.sum(isd * v, -1) - quad)
            # Elogpc (fCTM.jl:74-78)
            s = tau_c * alog(eta + eps) + (cd - tau_c) * alog(1.0 - eta + eps)
            e_pc = jnp.logaddexp(s, log_eps)
            # Elogpz (fCTM.jl:81-85)
            bound = jnp.sum(aexp(la + 0.5 * v - lz[:, None]), -1) + lz - 1.0
            e_pz = jnp.sum(pc * la, -1) - cd * bound
            # Elogpw (fCTM.jl:88-92)
            e_pw = jnp.sum(p * lt[..., K:2 * K] * (c * ta)[..., None], axis=(1, 2)) \
                + jnp.sum(c * (1.0 - ta) * lt[..., 2 * K], axis=-1)
            # −Elogqeta (fCTM.jl:95-98)
            e_qeta = mvnormal_diag_entropy(v)
            # −Elogqc (fCTM.jl:101-105)
            e_qc = jnp.sum(bernoulli_entropy(ta) * c, axis=-1)
            # −Elogqz (fCTM.jl:108-112)
            e_qz = jnp.sum(categorical_entropy(p) * c, axis=-1)
            # doc-level vs token-local terms in separate accumulators
            acc_doc = kbn_add(acc_doc,
                             jnp.sum(dm * (e_peta + e_pc + e_pz + e_qeta)))
            acc_tok = kbn_add(acc_tok, jnp.sum(dm * (e_pw + e_qc + e_qz)))
            return (acc_doc, acc_tok), None

        def sweep(t_a, c_a, dm_a, la_a, lao_a, v_a, lz_a, ta_a, tao_a, acc):
            n_rows = t_a.shape[0]
            B = min(chunk_docs, n_rows)
            n_chunks = n_rows // B
            sh = lambda x: x.reshape((n_chunks, B) + x.shape[1:])
            acc, _ = jax.lax.scan(
                scan_body, acc,
                (sh(t_a), sh(c_a), sh(dm_a), sh(la_a), sh(lao_a),
                 sh(v_a), sh(lz_a), sh(ta_a), sh(tao_a)),
            )
            return acc

        acc = (kbn_zero(dt), kbn_zero(dt))
        if seg_starts is None:
            acc = sweep(terms, counts, doc_mask, state.lam, state.lam_old,
                        state.vsq, state.logzeta, state.tau, state.tau_old,
                        acc)
        else:
            for lo0, t_a, c_a, dm_a in zip(seg_starts, terms, counts, doc_mask):
                lo_, hi_ = lo0, lo0 + t_a.shape[0]
                Ls = t_a.shape[1]
                acc = sweep(t_a, c_a, dm_a, state.lam[lo_:hi_],
                            state.lam_old[lo_:hi_], state.vsq[lo_:hi_],
                            state.logzeta[lo_:hi_], state.tau[lo_:hi_, :Ls],
                            state.tau_old[lo_:hi_, :Ls], acc)
        total_doc, total_tok = acc
        axes = axis_name if axis_name is not None else ()
        if isinstance(axes, str):
            axes = (axes,)
        if seq_axis is not None:
            total_tok = kbn_psum(total_tok, axes + (seq_axis,))
            total_doc = kbn_psum(total_doc, axes)
            return kbn_pack(kbn_merge(total_doc, total_tok))
        return kbn_pack(kbn_psum(kbn_merge(total_doc, total_tok), axes))

    return highest_precision(elbo)


def partition_spec(data_axis="data", vocab_axis: Optional[str] = None,
                   seq_axis: Optional[str] = None):
    from jax.sharding import PartitionSpec as P

    beta_spec = P(None, vocab_axis) if vocab_axis is not None else P()
    kappa_spec = P(vocab_axis) if vocab_axis is not None else P()
    tau_spec = P(data_axis, seq_axis) if seq_axis is not None else P(data_axis)
    return FCTMState(
        eta=P(), mu=P(), sigma=P(), invsigma=P(),
        kappa=kappa_spec, kappa_old=kappa_spec,
        beta=beta_spec, beta_old=beta_spec,
        lam=P(data_axis), lam_old=P(data_axis), vsq=P(data_axis),
        logzeta=P(data_axis), tau=tau_spec, tau_old=tau_spec, elbo=P(),
    )
