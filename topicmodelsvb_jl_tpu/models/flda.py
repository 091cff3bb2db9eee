"""Filtered latent Dirichlet allocation — batch-synchronous CAVI.

Redesign of the reference fLDA (``src/fLDA.jl``, the author's
own model, fLDA/fLDA.pdf): LDA plus a per-token Bernoulli switch
deciding content-word (topic-generated) vs background-word (drawn from
a corpus-wide distribution kappa), with global mixture weight eta.

Extra state vs LDA: scalar ``eta`` (fLDA.jl:14), background
distribution ``kappa`` [V] (+old/temp, fLDA.jl:16-18), per-token
responsibilities ``tau`` [M, N_d] (+old, fLDA.jl:25-26) — packed here
as dense masked [M_pad, L].

Update equations (cited per function below) mirror fLDA.jl exactly;
the schedule is the same per-doc-masked batch-synchronous sweep as
models/lda.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.newton import dirichlet_newton
from ..ops.packing import seg_loc_starts
from ..ops.segment import count_scatter
from ..utils.numerics import (
    EPSILON, alog, asoftmax, bernoulli_entropy, categorical_entropy,
    digamma, dirichlet_entropy, dirichlet_ones, finite, highest_precision,
    kbn_add, kbn_merge, kbn_pack, kbn_psum, kbn_zero, kbn_zeros, l2norm,
    lgamma, masked_fixpoint,
)


class FLDAState(NamedTuple):
    eta: jax.Array            # scalar
    alpha: jax.Array          # [K]
    kappa: jax.Array          # [V]
    kappa_old: jax.Array      # [V]
    beta: jax.Array           # [K, V]
    beta_old: jax.Array       # [K, V]
    gamma: jax.Array          # [M_pad, K]
    Elogtheta: jax.Array      # [M_pad, K]
    Elogtheta_old: jax.Array  # [M_pad, K]
    tau: jax.Array            # [M_pad, L]
    tau_old: jax.Array        # [M_pad, L]
    elbo: jax.Array


def init(key: jax.Array, packed, K: int, dtype=jnp.float32) -> FLDAState:
    """Constructor state (reference fLDA.jl:30-58)."""
    M_pad, V, L = packed.M_pad, packed.V, packed.L
    k_beta, k_kappa = jax.random.split(key)
    beta = dirichlet_ones(k_beta, V, (K,)).astype(dtype)
    kappa = dirichlet_ones(k_kappa, V).astype(dtype)
    eta = jnp.asarray(0.5, dtype)
    # ψ(K) = −γ + H_{K−1} ⇒ el0 = −H_{K−1} (host-side, no device fetch)
    el0 = -sum(1.0 / i for i in range(1, K))
    El = jnp.full((M_pad, K), jnp.asarray(el0, dtype), dtype)
    tau = jnp.full((M_pad, L), eta, dtype)
    return FLDAState(
        eta=eta, alpha=jnp.ones((K,), dtype), kappa=kappa, kappa_old=kappa,
        beta=beta, beta_old=beta, gamma=jnp.ones((M_pad, K), dtype),
        Elogtheta=El, Elogtheta_old=El, tau=tau, tau_old=tau,
        elbo=jnp.zeros((2,), dtype),
    )


def _phi(logbeta_d, tau, El, softmax=jax.nn.softmax):
    """phi ∝ exp(tau·log beta + Elogtheta), over K (fLDA.jl:204-207)."""
    return softmax(tau[..., None] * logbeta_d + El[:, None, :], axis=-1)


@highest_precision
def _estep_chunk(logbetaT, kappa_full, eta, alpha, terms, counts, doc_mask,
                 gamma, El, El_old, tau, tau_old, viter, vtol, V,
                 seq_axis=None, elogtheta_f64: bool = False):
    """With ``seq_axis`` each document's token axis is sharded over that
    mesh axis (SP analogue, SURVEY §5.7b): tau/phi rows live shard-local
    and every per-doc token reduction becomes a psum over the shards."""
    eps = jnp.asarray(EPSILON, gamma.dtype)
    # ONE combined [V, K+1] gather (logbeta lanes + a kappa lane): the
    # gather's cost is per-row, so the second width-1 kappa gather was
    # nearly as expensive as the K-wide one (fLDA.jl:199)
    K = logbetaT.shape[1]
    tab_d = jnp.concatenate([logbetaT, kappa_full[:, None]], axis=1)[terms]
    logbeta_d = tab_d[..., :K]           # [B, L, K]
    kappa_d = tab_d[..., K]              # [B, L]  raw kappa values
    active0 = doc_mask > 0

    def body(_, carry):
        gamma, El, El_old, tau, tau_old, active = carry
        p = _phi(logbeta_d, tau, El)
        # update_tau! (fLDA.jl:195-200):
        # tau = eta / (eta + (1-eta)·kappa_j·Π_k beta^{-phi} + EPS)
        s = jnp.sum(p * logbeta_d, axis=-1)           # Σ_k phi·log beta  [B, L]
        tau_new = eta / (eta + (1.0 - eta) * kappa_d * jnp.exp(-s) + eps)
        # update_gamma! (fLDA.jl:188-191)
        pc = jnp.einsum(
            "bl,blk->bk", counts, p, preferred_element_type=gamma.dtype
        )
        if seq_axis is not None:
            pc = jax.lax.psum(pc, seq_axis)
        gamma_new = alpha[None, :] + pc + eps
        # update_Elogtheta! (fLDA.jl:181-184); f64 digamma channel on
        # the [B, K] tile when requested (see models/lda.py)
        if elogtheta_f64:
            g64 = gamma_new.astype(jnp.float64)
            El_new = (digamma(g64)
                      - digamma(jnp.sum(g64, -1, keepdims=True))
                      ).astype(gamma.dtype)
        else:
            El_new = digamma(gamma_new) - digamma(jnp.sum(gamma_new, -1, keepdims=True))
        upd = active[:, None]
        gamma2 = jnp.where(upd, gamma_new, gamma)
        tau_old2 = jnp.where(upd, tau, tau_old)
        tau2 = jnp.where(upd, tau_new, tau)
        El_old2 = jnp.where(upd, El, El_old)
        El2 = jnp.where(upd, El_new, El)
        active2 = active & (l2norm(El2 - El_old2) >= vtol)
        return gamma2, El2, El_old2, tau2, tau_old2, active2

    gamma, El, El_old, tau, tau_old, _ = masked_fixpoint(
        body, (gamma, El, El_old, tau, tau_old, active0), viter)

    # stats use the last phi (f(beta, tau_old, Elogtheta_old)) with CURRENT tau:
    # beta_temp += phi .* (tau .* counts)' (fLDA.jl:174-177)
    # kappa_temp[terms] += (1 - tau) .* counts (fLDA.jl:160-163)
    # ONE fused scatter: both statistics reduce over the same token ids,
    # and scatter cost is per-row (see ROADMAP's scatter study) — the
    # kappa weight rides as an extra lane instead of a second pass
    p = _phi(logbeta_d, tau_old, El_old)
    w_beta = p * (tau * counts)[..., None]
    w_kappa = ((1.0 - tau) * counts)[..., None]
    w_full = jnp.concatenate([w_beta, w_kappa], axis=-1)     # [B, L, K+1]
    stat = count_scatter(w_full.reshape(-1, w_full.shape[-1]),
                         terms.reshape(-1), V)
    beta_temp, kappa_temp = stat[:, :-1], stat[:, -1]
    El_sum = jnp.sum(El * doc_mask[:, None], axis=0)
    tau_counts = jnp.sum(tau * counts)  # for update_eta! (fLDA.jl:122-124)
    return gamma, El, El_old, tau, tau_old, beta_temp, kappa_temp, El_sum, tau_counts


def make_step(packed, K: int, viter: int, vtol: float, niter: int, ntol: float,
              chunk_docs: int, axis_name=None,
              vocab_axis: Optional[str] = None, seq_axis: Optional[str] = None,
              elogtheta_f64: bool = False):
    """``vocab_axis`` shards beta [K, V] and kappa [V] storage (TP, like
    models/lda.py): all_gather in, reduce_scatter + psum'd sums out.
    ``seq_axis`` shards every document's token axis (and the tau state)
    over that mesh axis (SP analogue, SURVEY §5.7b); incompatible with
    bucketed packing, like models/lda.py."""
    V = packed.V
    seg_starts = seg_loc_starts(packed)
    if elogtheta_f64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "elogtheta_f64 requires jax_enable_x64 (see models/lda.py)")
    if seq_axis is not None:
        assert seg_starts is None, "token-axis sharding requires dense packing"

    def step(state: FLDAState, terms, counts, doc_mask, M_total, C_total):
        eps = jnp.asarray(EPSILON, state.beta.dtype)
        dt = state.beta.dtype
        if vocab_axis is not None:
            beta_full = jax.lax.all_gather(state.beta, vocab_axis, axis=1, tiled=True)
            kappa_full_v = jax.lax.all_gather(state.kappa, vocab_axis, axis=0, tiled=True)
        else:
            beta_full, kappa_full_v = state.beta, state.kappa
        logbetaT = jnp.log(beta_full + eps).T

        def scan_body_xla(carry, xs):
            bt, kt, es, tc = carry
            t, c, dm, g, el, elo, ta, tao = xs
            g2, el2, elo2, ta2, tao2, bti, kti, esi, tci = _estep_chunk(
                logbetaT, kappa_full_v, state.eta, state.alpha,
                t, c, dm, g, el, elo, ta, tao, viter, vtol, V,
                seq_axis=seq_axis, elogtheta_f64=elogtheta_f64,
            )
            return (bt + bti, kt + kti, kbn_add(es, esi), tc + tci), (g2, el2, elo2, ta2, tao2)

        def sweep(t_a, c_a, dm_a, g_a, el_a, elo_a, ta_a, tao_a, carry):
            n_rows = t_a.shape[0]
            B = min(chunk_docs, n_rows)
            n_chunks = n_rows // B
            sh = lambda a: a.reshape((n_chunks, B) + a.shape[1:])
            carry, ys = jax.lax.scan(
                scan_body_xla, carry,
                (sh(t_a), sh(c_a), sh(dm_a), sh(g_a),
                 sh(el_a), sh(elo_a), sh(ta_a), sh(tao_a)),
            )
            unsh = lambda a: a.reshape((n_rows,) + a.shape[2:])
            return carry, tuple(unsh(y) for y in ys)

        # Elogtheta_sum rides a compensated (hi, lo) carry — same
        # alpha-channel noise fix as models/lda.py make_step
        carry = (jnp.zeros((V, K), dt), jnp.zeros((V,), dt),
                 kbn_zeros((K,), dt), jnp.zeros((), dt))
        if seg_starts is None:
            carry, (gamma, El, El_old, tau, tau_old) = sweep(
                terms, counts, doc_mask, state.gamma, state.Elogtheta,
                state.Elogtheta_old, state.tau, state.tau_old, carry)
        else:
            # tau/tau_old stay dense [local, L_max]; each segment slices
            # its rows AND its own token width (cols beyond a doc's
            # segment width are never read — doc N ≤ segment L)
            Lmax = state.tau.shape[1]
            parts = []
            for lo0, t_a, c_a, dm_a in zip(seg_starts, terms, counts, doc_mask):
                lo, hi = lo0, lo0 + t_a.shape[0]
                Ls = t_a.shape[1]
                carry, ys = sweep(
                    t_a, c_a, dm_a, state.gamma[lo:hi],
                    state.Elogtheta[lo:hi], state.Elogtheta_old[lo:hi],
                    state.tau[lo:hi, :Ls], state.tau_old[lo:hi, :Ls], carry)
                g2, el2, elo2, ta2, tao2 = ys
                padL = lambda a: jnp.pad(
                    a, ((0, 0), (0, Lmax - Ls)), constant_values=0.5)
                parts.append((g2, el2, elo2, padL(ta2), padL(tao2)))
            gamma, El, El_old, tau, tau_old = (
                jnp.concatenate([p_[i] for p_ in parts], axis=0)
                for i in range(5))

        beta_temp, kappa_temp, El_sum, tau_counts = carry
        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name or ())
        # token-level statistics also sum over the token shards; El_sum
        # is doc-level and identical on every seq shard (data axes only)
        axes_tok = axes + (seq_axis,) if seq_axis is not None else axes
        if axes:
            El_sum = kbn_psum(El_sum, axes)
        if axes_tok:
            tau_counts = jax.lax.psum(tau_counts, axes_tok)

        if vocab_axis is not None:
            from ..parallel.shard import tp_normalize_rows

            bt_local, row_sum = tp_normalize_rows(beta_temp, vocab_axis, axes_tok)
            kt_local, k_sum = tp_normalize_rows(
                kappa_temp[:, None], vocab_axis, axes_tok)
            beta_new = bt_local.T / row_sum[:, None]
            kappa_new = kt_local[:, 0] / k_sum[0]
        else:
            if axes_tok:
                beta_temp = jax.lax.psum(beta_temp, axes_tok)
                kappa_temp = jax.lax.psum(kappa_temp, axes_tok)
            beta_new = beta_temp.T / jnp.sum(beta_temp.T, axis=1, keepdims=True)
            kappa_new = kappa_temp / jnp.sum(kappa_temp)     # fLDA.jl:152-156
        alpha_new = dirichlet_newton(state.alpha, El_sum[0], M_total,
                                     niter, ntol, Elogtheta_sum_lo=El_sum[1])
        eta_new = tau_counts / C_total                        # fLDA.jl:122-124

        return FLDAState(
            eta=eta_new, alpha=alpha_new, kappa=kappa_new, kappa_old=state.kappa,
            beta=beta_new, beta_old=state.beta, gamma=gamma,
            Elogtheta=El, Elogtheta_old=El_old, tau=tau, tau_old=tau_old,
            elbo=state.elbo,
        )

    return highest_precision(step)


def make_elbo(packed, K: int, chunk_docs: int, axis_name=None,
              vocab_axis: Optional[str] = None, seq_axis: Optional[str] = None):
    """ELBO with the reference's *_old recompute semantics (fLDA.jl:109-118)."""
    V = packed.V

    seg_starts = seg_loc_starts(packed)
    if seq_axis is not None:
        assert seg_starts is None, "token-axis sharding requires dense packing"

    def elbo(state: FLDAState, terms, counts, doc_mask):
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
        a = state.alpha
        eta = state.eta
        theta_const = finite(lgamma(jnp.sum(a))) - finite(jnp.sum(lgamma(a)))
        log_eps = jnp.log(eps)

        # one combined [V, 2K+1] table — the three per-token gathers
        # (logbeta_old, logbeta, logkappa) pay their per-row cost once
        log_tabT = jnp.concatenate(
            [logbeta_oldT, logbetaT, logkappa[:, None]], axis=1)

        def scan_body(acc, xs):
            acc_doc, acc_tok = acc
            t, c, dm, g, el, elo, ta, tao = xs
            lt = log_tabT[t]                             # [B, L, 2K+1]
            # phi recompute from tau_old/beta_old/Elogtheta_old (fLDA.jl:113)
            p = _phi(lt[..., :K], tao, elo, softmax=asoftmax)
            C_d = jnp.sum(c, -1)
            tau_c = jnp.sum(ta * c, -1)
            pc = jnp.einsum("bl,blk->bk", c, p, preferred_element_type=dt)
            if seq_axis is not None:
                # per-doc token reductions complete across the shards
                # BEFORE the nonlinear Elogpc term is formed
                C_d = jax.lax.psum(C_d, seq_axis)
                tau_c = jax.lax.psum(tau_c, seq_axis)
                pc = jax.lax.psum(pc, seq_axis)
            # Elogptheta (fLDA.jl:62-65)
            e_ptheta = theta_const + jnp.sum((a - 1.0) * el, -1)
            # Elogpc (fLDA.jl:68-71): log(eta^a (1-eta)^b + EPS) — mirrors the
            # reference's @boink saturation exactly via logaddexp
            s = tau_c * alog(eta + eps) + (C_d - tau_c) * alog(1.0 - eta + eps)
            e_pc = jnp.logaddexp(s, log_eps)
            # Elogpz (fLDA.jl:74-78)
            e_pz = jnp.sum(pc * el, -1)
            # Elogpw (fLDA.jl:82-86)
            e_pw = jnp.sum(p * lt[..., K:2 * K] * (c * ta)[..., None], axis=(1, 2)) \
                + jnp.sum(c * (1.0 - ta) * lt[..., 2 * K], axis=-1)
            # −Elogqtheta (fLDA.jl:89-92)
            e_qtheta = dirichlet_entropy(g)
            # −Elogqc (fLDA.jl:95-98)
            e_qc = jnp.sum(bernoulli_entropy(ta) * c, axis=-1)
            # −Elogqz (fLDA.jl:102-105)
            e_qz = jnp.sum(categorical_entropy(p) * c, axis=-1)
            # doc-level terms are replicated across token shards; token-
            # level terms are shard-local — separate accumulators
            acc_doc = kbn_add(acc_doc,
                             jnp.sum(dm * (e_ptheta + e_pc + e_pz + e_qtheta)))
            acc_tok = kbn_add(acc_tok, jnp.sum(dm * (e_pw + e_qc + e_qz)))
            return (acc_doc, acc_tok), None

        def sweep(t_a, c_a, dm_a, g_a, el_a, elo_a, ta_a, tao_a, acc):
            n_rows = t_a.shape[0]
            B = min(chunk_docs, n_rows)
            n_chunks = n_rows // B
            body = scan_body
            sh = lambda x: x.reshape((n_chunks, B) + x.shape[1:])
            acc, _ = jax.lax.scan(
                body, acc,
                (sh(t_a), sh(c_a), sh(dm_a), sh(g_a),
                 sh(el_a), sh(elo_a), sh(ta_a), sh(tao_a)),
            )
            return acc

        acc = (kbn_zero(dt), kbn_zero(dt))
        if seg_starts is None:
            acc = sweep(terms, counts, doc_mask, state.gamma,
                        state.Elogtheta, state.Elogtheta_old,
                        state.tau, state.tau_old, acc)
        else:
            for lo0, t_a, c_a, dm_a in zip(seg_starts, terms, counts, doc_mask):
                lo, hi = lo0, lo0 + t_a.shape[0]
                Ls = t_a.shape[1]
                acc = sweep(t_a, c_a, dm_a, state.gamma[lo:hi],
                            state.Elogtheta[lo:hi],
                            state.Elogtheta_old[lo:hi],
                            state.tau[lo:hi, :Ls],
                            state.tau_old[lo:hi, :Ls], acc)
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
    # tau is per-token state: under SP its token axis shards with the data
    tau_spec = P(data_axis, seq_axis) if seq_axis is not None else P(data_axis)
    return FLDAState(
        eta=P(), alpha=P(), kappa=kappa_spec, kappa_old=kappa_spec,
        beta=beta_spec, beta_old=beta_spec,
        gamma=P(data_axis), Elogtheta=P(data_axis), Elogtheta_old=P(data_axis),
        tau=tau_spec, tau_old=tau_spec, elbo=P(),
    )
