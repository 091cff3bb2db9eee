"""Collaborative topic Poisson factorization — batch-synchronous CAVI.

Redesign of the reference CTPF (``src/CTPF.jl``,
Gopalan/Charlin/Blei) and its OpenCL twin (``src/gpuCTPF.jl``, 12
kernels — one per Hebrew-letter Gamma variational parameter plus the
phi/xi softmaxes).  Document content (terms) and user behavior
(readers/ratings) are fused: Gamma posteriors alef/bet (topic-word),
gimel/dalet (doc-topic), he/vav (user-pref), zayin/het (doc-offset),
multinomial responsibilities phi [K per token] and xi [2K per rating,
stacking content vs offset halves, CTPF.jl:102].

Design notes vs the reference:

* phi and xi are recomputed inside the fused chunk body, never stored
  (the reference's warm-start identity, modelutils.jl:231-240).
* The alef/he scatters (CTPF.jl:259-262, 274-277) are segment-sums
  over vocab/user ids (see ops/segment.py for their determinism).
* **ELBO without the O(count) binomial sums**: the reference evaluates
  Σ_y pdf(Binom(c, φ), y)·lnΓ(y+1) per token/rating inside Elogpz /
  Elogpya / Elogpyb (CTPF.jl:116,127,138) *and* the exact multinomial
  entropies in Elogqz/Elogqy (CTPF.jl:180-195).  These E[lnΓ(y_i+1)]
  terms cancel exactly: for y ~ Mult(n, p),
  H = −lnΓ(n+1) + Σ_i E[lnΓ(y_i+1)] − n·Σ_i p_i·ln p_i, so
  (Elogp − Elogq) keeps only −lnΓ(n+1) − n·Σ p ln p plus the linear
  terms.  The device ELBO is closed-form; equality with the
  transliterated reference form is proven in tests/test_ctpf.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.packing import seg_loc_starts
from ..ops.segment import count_scatter
from ..utils.numerics import (
    aexp, alog, asoftmax, digamma, dirichlet_ones, gamma_entropy,
    highest_precision, kbn_add, kbn_merge, kbn_pack, kbn_psum, kbn_zero,
    l2norm, lgamma, masked_fixpoint,
)

# Gamma hyperpriors a..h = 0.1 (CTPF.jl:81)
HYPER = dict(a=0.1, b=0.1, c=0.1, d=0.1, e=0.1, f=0.1, g=0.1, h=0.1)


class CTPFState(NamedTuple):
    alef: jax.Array       # [K, V]
    alef_old: jax.Array
    bet: jax.Array        # [K]
    bet_old: jax.Array
    gimel: jax.Array      # [M_pad, K]
    gimel_old: jax.Array
    dalet: jax.Array      # [K]
    dalet_old: jax.Array
    he: jax.Array         # [K, U_seg]
    he_old: jax.Array
    vav: jax.Array        # [K]
    vav_old: jax.Array
    zayin: jax.Array      # [M_pad, K]
    zayin_old: jax.Array
    het: jax.Array        # [K]
    het_old: jax.Array
    elbo: jax.Array


def init(key: jax.Array, packed, K: int, dtype=jnp.float32) -> CTPFState:
    """Constructor state (reference CTPF.jl:81-103)."""
    M_pad, V = packed.M_pad, packed.V
    U_seg = max(packed.U, 1)
    alef = jnp.exp(
        dirichlet_ones(key, V, (K,)) - 0.5
    ).astype(dtype)
    ones_k = jnp.ones((K,), dtype)
    return CTPFState(
        alef=alef, alef_old=alef,
        bet=ones_k, bet_old=ones_k,
        gimel=jnp.ones((M_pad, K), dtype), gimel_old=jnp.ones((M_pad, K), dtype),
        dalet=ones_k, dalet_old=ones_k,
        he=jnp.ones((K, U_seg), dtype), he_old=jnp.ones((K, U_seg), dtype),
        vav=ones_k, vav_old=ones_k,
        zayin=jnp.ones((M_pad, K), dtype), zayin_old=jnp.ones((M_pad, K), dtype),
        het=ones_k, het_old=ones_k,
        elbo=jnp.zeros((2,), dtype),
    )


def _phi(dg_alef_d, dg_gimel, log_dalet, log_bet, softmax=jax.nn.softmax):
    """phi ∝ exp(ψ(gimel) − log dalet − log bet + ψ(alef[:,terms])), over K
    (CTPF.jl:327-330)."""
    return softmax(
        dg_alef_d + (dg_gimel - log_dalet - log_bet)[:, None, :], axis=-1
    )


def _xi(dg_he_d, dg_gimel, dg_zayin, log_dalet, log_het, log_vav,
        exp=jnp.exp):
    """xi ∝ softmax over 2K of stacked content/offset halves (CTPF.jl:334-337).

    Returns ([B,R,K] top, [B,R,K] bottom)."""
    top = dg_he_d + (dg_gimel - log_dalet - log_vav)[:, None, :]
    bot = dg_he_d + (dg_zayin - log_het - log_vav)[:, None, :]
    m = jnp.maximum(jnp.max(top, -1, keepdims=True), jnp.max(bot, -1, keepdims=True))
    et, eb = exp(top - m), exp(bot - m)
    z = jnp.sum(et, -1, keepdims=True) + jnp.sum(eb, -1, keepdims=True)
    return et / z, eb / z


@highest_precision
def _estep_chunk(dg_alefT, dg_heT, log_bet, log_vav,
                 c_hyper, g_hyper, terms, counts, readers, ratings, doc_mask,
                 gimel, gimel_old, zayin, zayin_old, viter, vtol, V, U_seg,
                 dalet, het, seq_axis=None):
    """With ``seq_axis`` both ragged axes of a document — its token
    stream *and* its reader list (the second raggedness axis,
    CTPF.jl:102) — are sharded over that mesh axis (SP analogue, SURVEY
    §5.7b): phi/xi stay shard-local and the per-doc gimel/zayin
    reductions (CTPF.jl:309-323) are psums over the shards."""
    dtype = gimel.dtype
    dg_alef_d = dg_alefT[terms]      # [B, L, K]
    dg_he_d = dg_heT[readers]        # [B, R, K]
    log_dalet = jnp.log(dalet)
    log_het = jnp.log(het)
    active0 = doc_mask > 0

    def body(_, carry):
        gimel, gimel_old, zayin, zayin_old, active = carry
        dg_gimel = digamma(gimel)
        dg_zayin = digamma(zayin)
        # update_xi! then update_phi! (CTPF.jl:355-356)
        xi_top, xi_bot = _xi(dg_he_d, dg_gimel, dg_zayin,
                             log_dalet[None, :], log_het[None, :], log_vav[None, :])
        p = _phi(dg_alef_d, dg_gimel, log_dalet[None, :], log_bet[None, :])
        # update_zayin! (CTPF.jl:318-323): zayin = g + xi_bot @ ratings
        zsum = jnp.einsum(
            "br,brk->bk", ratings, xi_bot, preferred_element_type=dtype
        )
        # update_gimel! (CTPF.jl:309-314): gimel = c + phi@counts + xi_top@ratings
        gsum = jnp.einsum(
            "bl,blk->bk", counts, p, preferred_element_type=dtype
        ) + jnp.einsum("br,brk->bk", ratings, xi_top, preferred_element_type=dtype)
        if seq_axis is not None:
            zsum, gsum = jax.lax.psum((zsum, gsum), seq_axis)
        zayin_new = g_hyper + zsum
        gimel_new = c_hyper + gsum
        upd = active[:, None]
        zayin_old2 = jnp.where(upd, zayin, zayin_old)
        zayin2 = jnp.where(upd, zayin_new, zayin)
        gimel_old2 = jnp.where(upd, gimel, gimel_old)
        gimel2 = jnp.where(upd, gimel_new, gimel)
        # break: ‖gimel − gimel_old‖ < vtol (CTPF.jl:359)
        active2 = active & (l2norm(gimel2 - gimel_old2) >= vtol)
        return gimel2, gimel_old2, zayin2, zayin_old2, active2

    gimel, gimel_old, zayin, zayin_old, _ = masked_fixpoint(
        body, (gimel, gimel_old, zayin, zayin_old, active0), viter)

    # stats with the last phi/xi = f(gimel_old, zayin_old) (CTPF.jl:259-277)
    dg_gimel_o = digamma(gimel_old)
    dg_zayin_o = digamma(zayin_old)
    p = _phi(dg_alef_d, dg_gimel_o, log_dalet[None, :], log_bet[None, :])
    xi_top, xi_bot = _xi(dg_he_d, dg_gimel_o, dg_zayin_o,
                         log_dalet[None, :], log_het[None, :], log_vav[None, :])
    w_alef = p * counts[..., None]
    alef_temp = count_scatter(w_alef.reshape(-1, w_alef.shape[-1]), terms.reshape(-1), V)
    w_he = (xi_top + xi_bot) * ratings[..., None]
    he_temp = count_scatter(w_he.reshape(-1, w_he.shape[-1]), readers.reshape(-1), U_seg)
    dm = doc_mask[:, None]
    gimel_sum = jnp.sum(gimel * dm, axis=0)
    zayin_sum = jnp.sum(zayin * dm, axis=0)
    return gimel, gimel_old, zayin, zayin_old, alef_temp, he_temp, gimel_sum, zayin_sum


def make_step(packed, K: int, viter: int, vtol: float, chunk_docs: int,
              axis_name=None, hyper: dict = HYPER,
              vocab_axis: Optional[str] = None, user_axis: Optional[str] = None,
              seq_axis: Optional[str] = None):
    """One CAVI sweep.  ``vocab_axis``/``user_axis`` shard alef [K, V]
    and he [K, U] *storage* over those mesh axes (TP; SURVEY §2.3 notes
    he is the natural U-axis shard): all_gather in, reduce_scatter +
    psum'd row sums out; include the axes in ``axis_name`` and shard
    docs over every mesh axis."""
    V = packed.V
    U = packed.U
    U_seg = max(U, 1)
    a, b, c, d = hyper["a"], hyper["b"], hyper["c"], hyper["d"]
    e, f, g, h = hyper["e"], hyper["f"], hyper["g"], hyper["h"]
    seg_starts = seg_loc_starts(packed)
    if seq_axis is not None:
        assert seg_starts is None, "token/reader-axis sharding requires dense packing"

    def step(state: CTPFState, terms, counts, readers, ratings, doc_mask):
        dt = state.alef.dtype
        alef_full = (jax.lax.all_gather(state.alef, vocab_axis, axis=1, tiled=True)
                     if vocab_axis is not None else state.alef)
        he_full = (jax.lax.all_gather(state.he, user_axis, axis=1, tiled=True)
                   if user_axis is not None else state.he)
        dg_alefT = digamma(alef_full).T        # [V, K]
        dg_heT = digamma(he_full).T            # [U_seg, K]
        log_bet = jnp.log(state.bet)
        log_vav = jnp.log(state.vav)

        def scan_body_xla(carry, xs):
            at, ht, gs, zs = carry
            t, cnt, rd, rt, dm, gi, gio, za, zao = xs
            gi2, gio2, za2, zao2, ati, hti, gsi, zsi = _estep_chunk(
                dg_alefT, dg_heT, log_bet, log_vav,
                c, g, t, cnt, rd, rt, dm, gi, gio, za, zao,
                viter, vtol, V, U_seg, state.dalet, state.het,
                seq_axis=seq_axis,
            )
            return (at + ati, ht + hti, gs + gsi, zs + zsi), (gi2, gio2, za2, zao2)

        def sweep(t_a, c_a, rd_a, rt_a, dm_a, gi_a, gio_a, za_a, zao_a, carry):
            n_rows = t_a.shape[0]
            B = min(chunk_docs, n_rows)
            n_chunks = n_rows // B
            sh = lambda x: x.reshape((n_chunks, B) + x.shape[1:])
            carry, ys = jax.lax.scan(
                scan_body_xla, carry,
                (sh(t_a), sh(c_a), sh(rd_a), sh(rt_a), sh(dm_a),
                 sh(gi_a), sh(gio_a), sh(za_a), sh(zao_a)),
            )
            unsh = lambda x: x.reshape((n_rows,) + x.shape[2:])
            return carry, tuple(unsh(y) for y in ys)

        carry = (jnp.zeros((V, K), dt), jnp.zeros((U_seg, K), dt),
                 jnp.zeros((K,), dt), jnp.zeros((K,), dt))
        if seg_starts is None:
            carry, (gimel, gimel_old, zayin, zayin_old) = sweep(
                terms, counts, readers, ratings, doc_mask,
                state.gimel, state.gimel_old, state.zayin, state.zayin_old,
                carry)
        else:
            # token axis bucketed per segment; reader arrays stay dense
            # [local, Rmax] and are row-sliced per segment
            parts = []
            for lo0, t_a, c_a, dm_a in zip(seg_starts, terms, counts, doc_mask):
                lo_, hi_ = lo0, lo0 + t_a.shape[0]
                carry, ys = sweep(
                    t_a, c_a, readers[lo_:hi_], ratings[lo_:hi_], dm_a,
                    state.gimel[lo_:hi_], state.gimel_old[lo_:hi_],
                    state.zayin[lo_:hi_], state.zayin_old[lo_:hi_], carry)
                parts.append(ys)
            gimel, gimel_old, zayin, zayin_old = (
                jnp.concatenate([p_[i] for p_ in parts], axis=0)
                for i in range(4))
        alef_temp, he_temp, gimel_sum, zayin_sum = carry

        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name or ())
        # alef/he stats are token/reader-local: sum the seq shards too;
        # gimel/zayin sums are doc-level (identical across seq shards)
        axes_tok = axes + (seq_axis,) if seq_axis is not None else axes
        if axes:
            gimel_sum = jax.lax.psum(gimel_sum, axes)
            zayin_sum = jax.lax.psum(zayin_sum, axes)

        def reduce_stat(temp, shard_axis):
            """psum the [rows, K] statistic; keep only this shard's rows
            when the parameter's storage is sharded over ``shard_axis``."""
            if shard_axis is not None:
                from ..parallel.shard import tp_normalize_rows

                local, _ = tp_normalize_rows(temp, shard_axis, axes_tok)
                return local
            return jax.lax.psum(temp, axes_tok) if axes_tok else temp

        alef_temp = reduce_stat(alef_temp, vocab_axis)
        he_temp = reduce_stat(he_temp, user_axis)

        # global updates, reference order (CTPF.jl:366-371):
        # he (CTPF.jl:266-270), alef (CTPF.jl:251-255) — init-filled temps
        he_new = e + he_temp.T
        alef_new = a + alef_temp.T
        # dalet (CTPF.jl:295-298): new alef/he, OLD bet/vav — row sums run
        # over the full V/U, so sharded storage psums its local partials
        he_sum = jnp.sum(he_new, axis=1) if U > 0 else jnp.zeros((K,), dt)
        if user_axis is not None and U > 0:
            he_sum = jax.lax.psum(he_sum, user_axis)
        alef_sum = jnp.sum(alef_new, axis=1)
        if vocab_axis is not None:
            alef_sum = jax.lax.psum(alef_sum, vocab_axis)
        dalet_new = d + alef_sum / state.bet + he_sum / state.vav
        # het (CTPF.jl:302-305): old vav
        het_new = h + he_sum / state.vav
        # bet (CTPF.jl:281-284): NEW dalet
        bet_new = b + gimel_sum / dalet_new
        # vav (CTPF.jl:288-291): NEW dalet and het
        vav_new = f + gimel_sum / dalet_new + zayin_sum / het_new

        return CTPFState(
            alef=alef_new, alef_old=state.alef, bet=bet_new, bet_old=state.bet,
            gimel=gimel, gimel_old=gimel_old, dalet=dalet_new, dalet_old=state.dalet,
            he=he_new, he_old=state.he, vav=vav_new, vav_old=state.vav,
            zayin=zayin, zayin_old=zayin_old, het=het_new, het_old=state.het,
            elbo=state.elbo,
        )

    return highest_precision(step)


def make_elbo(packed, K: int, chunk_docs: int, axis_name=None,
              hyper: dict = HYPER,
              vocab_axis: Optional[str] = None, user_axis: Optional[str] = None,
              seq_axis: Optional[str] = None,
              include_global_terms: bool = True):
    """Closed-form ELBO (CTPF.jl:110-247 with the E[lnΓ(y+1)] cancellation).

    phi/xi recomputed from the *_old parameter set (CTPF.jl:240-241);
    all bound terms use current parameters.  ``include_global_terms=False``
    returns only the per-document/token part — the streaming driver sums
    batch contributions and adds the data-independent alef/he terms once.
    """
    V, U = packed.V, packed.U
    U_seg = max(U, 1)
    a, b, c, d = hyper["a"], hyper["b"], hyper["c"], hyper["d"]
    e, f, g, h = hyper["e"], hyper["f"], hyper["g"], hyper["h"]

    def _xlogx(p):
        return jnp.where(p > 0, p * alog(jnp.where(p > 0, p, 1.0)), 0.0)

    seg_starts = seg_loc_starts(packed)
    if seq_axis is not None:
        assert seg_starts is None, "token/reader-axis sharding requires dense packing"

    def elbo(state: CTPFState, terms, counts, readers, ratings, doc_mask):
        dt = state.alef.dtype
        # under TP the alef/he storage is sharded; gather once and
        # evaluate the bound on the full tensors (like the other models)
        if vocab_axis is not None:
            alef = jax.lax.all_gather(state.alef, vocab_axis, axis=1, tiled=True)
            alef_old = jax.lax.all_gather(state.alef_old, vocab_axis,
                                          axis=1, tiled=True)
        else:
            alef, alef_old = state.alef, state.alef_old
        if user_axis is not None:
            he = jax.lax.all_gather(state.he, user_axis, axis=1, tiled=True)
            he_old = jax.lax.all_gather(state.he_old, user_axis,
                                        axis=1, tiled=True)
        else:
            he, he_old = state.he, state.he_old
        het, het_old = state.het, state.het_old

        # old-param responsibilities (CTPF.jl:240-241)
        dg_alef_oT = digamma(alef_old).T
        dg_he_oT = digamma(he_old).T
        log_bet_o = alog(state.bet_old)
        log_vav_o = alog(state.vav_old)
        log_dalet_o = alog(state.dalet_old)
        log_het_o = alog(het_old)
        # current params for the bound
        dg_alef = digamma(alef)
        dg_he = digamma(he)
        log_bet = alog(state.bet)
        log_vav = alog(state.vav)
        log_dalet = alog(state.dalet)
        log_het = alog(het)
        alef_sum = jnp.sum(alef, axis=1)                     # Σ_j alef [K]
        he_sum = jnp.sum(he, axis=1) if U > 0 else jnp.zeros((K,), dt)
        dg_alefT_cur = dg_alef.T
        dg_heT_cur = dg_he.T

        # ── global terms (data-independent; skipped for streamed batch
        # contributions past the first, include_global_terms=False) ──
        if include_global_terms:
            # Elogpbeta (CTPF.jl:144-150) − Elogqbeta (CTPF.jl:198-204)
            e_pbeta = V * K * (a * alog(jnp.asarray(b, dt)) - lgamma(jnp.asarray(a, dt))) \
                + jnp.sum((a - 1.0) * (dg_alef - log_bet[:, None])
                          - b * alef / state.bet[:, None])
            e_qbeta_ent = jnp.sum(gamma_entropy(alef, state.bet[:, None]))
            # Elogpeta (CTPF.jl:162-168) − Elogqeta (CTPF.jl:216-222)
            if U > 0:
                e_peta = U * K * (e * alog(jnp.asarray(f, dt)) - lgamma(jnp.asarray(e, dt))) \
                    + jnp.sum((e - 1.0) * (dg_he - log_vav[:, None])
                              - f * he / state.vav[:, None])
                e_qeta_ent = jnp.sum(gamma_entropy(he, state.vav[:, None]))
            else:
                e_peta = jnp.zeros((), dt)
                e_qeta_ent = jnp.zeros((), dt)
        else:
            e_pbeta = e_qbeta_ent = e_peta = e_qeta_ent = jnp.zeros((), dt)

        # combined [V, 2K] / [U, 2K] tables: the old- and current-param
        # per-token (and per-rating) gathers pay their per-row cost once
        vtab = jnp.concatenate([dg_alef_oT, dg_alefT_cur], axis=1)
        utab = jnp.concatenate([dg_he_oT, dg_heT_cur], axis=1)

        def scan_body(acc, xs):
            t, cnt, rd, rt, dm, gi, gio, za, zao = xs
            vt = vtab[t]                                  # [B, L, 2K]
            ut = utab[rd]                                 # [B, R, 2K]
            dg_gi_o, dg_za_o = digamma(gio), digamma(zao)
            p = _phi(vt[..., :K], dg_gi_o, log_dalet_o[None, :],
                     log_bet_o[None, :], softmax=asoftmax)
            xi_top, xi_bot = _xi(ut[..., :K], dg_gi_o, dg_za_o,
                                 log_dalet_o[None, :], log_het_o[None, :],
                                 log_vav_o[None, :], exp=aexp)
            dg_gi, dg_za = digamma(gi), digamma(za)

            # Elogpya + Elogpyb − Elogqy, E[lnΓ] cancelled (CTPF.jl:111-130, 180-186)
            lin_top = (dg_gi - log_dalet)[:, None, :] + ut[..., K:] - log_vav[None, None, :]
            lin_bot = (dg_za - log_het)[:, None, :] + ut[..., K:] - log_vav[None, None, :]
            rate_lin = jnp.sum(rt[..., None] * (xi_top * lin_top + xi_bot * lin_bot),
                               axis=(1, 2))
            xi_ent = jnp.sum(_xlogx(xi_top) + _xlogx(xi_bot), axis=-1)   # Σ xi ln xi
            rate_q = jnp.sum(lgamma(rt + 1.0) + rt * xi_ent, axis=1)
            dot_ya = jnp.sum((gi / (state.dalet * state.vav)) * he_sum, -1)
            dot_yb = jnp.sum((za / (het * state.vav)) * he_sum, -1)

            # Elogpz − Elogqz, E[lnΓ] cancelled (CTPF.jl:133-141, 189-195)
            lin_z = (dg_gi - log_dalet)[:, None, :] + vt[..., K:] - log_bet[None, None, :]
            tok_lin = jnp.sum(cnt[..., None] * p * lin_z, axis=(1, 2))
            p_ent = jnp.sum(_xlogx(p), axis=-1)
            tok_q = jnp.sum(lgamma(cnt + 1.0) + cnt * p_ent, axis=1)
            dot_z = jnp.sum((gi / (state.dalet * state.bet)) * alef_sum, -1)

            # Elogptheta (CTPF.jl:153-159) − Elogqtheta (CTPF.jl:207-213)
            e_pth = K * (c * alog(jnp.asarray(d, dt)) - lgamma(jnp.asarray(c, dt))) \
                + jnp.sum((c - 1.0) * (dg_gi - log_dalet) - d * gi / state.dalet, -1)
            e_qth = jnp.sum(gamma_entropy(gi, state.dalet[None, :]), -1)
            # Elogpepsilon (CTPF.jl:171-177) − Elogqepsilon (CTPF.jl:225-231)
            e_pep = K * (g * alog(jnp.asarray(h, dt)) - lgamma(jnp.asarray(g, dt))) \
                + jnp.sum((g - 1.0) * (dg_za - log_het) - h * za / het, -1)
            e_qep = jnp.sum(gamma_entropy(za, het[None, :]), -1)

            # doc-level terms (dot_* use the current gimel/zayin plus the
            # full alef/he sums) are replicated across seq shards; the
            # token/reader-linear terms are shard-local partial sums
            acc_doc, acc_tok = acc
            acc_doc = kbn_add(acc_doc, jnp.sum(dm * (
                -dot_ya - dot_yb - dot_z + e_pth + e_qth + e_pep + e_qep)))
            acc_tok = kbn_add(acc_tok, jnp.sum(dm * (
                rate_lin - rate_q + tok_lin - tok_q)))
            return (acc_doc, acc_tok), None

        def sweep(t_a, c_a, rd_a, rt_a, dm_a, gi_a, gio_a, za_a, zao_a, acc):
            n_rows = t_a.shape[0]
            B = min(chunk_docs, n_rows)
            n_chunks = n_rows // B
            sh = lambda x: x.reshape((n_chunks, B) + x.shape[1:])
            acc, _ = jax.lax.scan(
                scan_body, acc,
                (sh(t_a), sh(c_a), sh(rd_a), sh(rt_a), sh(dm_a),
                 sh(gi_a), sh(gio_a), sh(za_a), sh(zao_a)),
            )
            return acc

        acc = (kbn_zero(dt), kbn_zero(dt))
        if seg_starts is None:
            acc = sweep(terms, counts, readers, ratings, doc_mask,
                        state.gimel, state.gimel_old,
                        state.zayin, state.zayin_old, acc)
        else:
            for lo0, t_a, c_a, dm_a in zip(seg_starts, terms, counts, doc_mask):
                lo_, hi_ = lo0, lo0 + t_a.shape[0]
                acc = sweep(t_a, c_a, readers[lo_:hi_], ratings[lo_:hi_],
                            dm_a, state.gimel[lo_:hi_],
                            state.gimel_old[lo_:hi_],
                            state.zayin[lo_:hi_],
                            state.zayin_old[lo_:hi_], acc)
        per_doc, per_tok = acc
        axes = axis_name if axis_name is not None else ()
        if isinstance(axes, str):
            axes = (axes,)
        if seq_axis is not None:
            per_tok = kbn_psum(per_tok, axes + (seq_axis,))
            per_doc = kbn_psum(per_doc, axes)
        elif axes:
            per_doc = kbn_psum(per_doc, axes)
            per_tok = kbn_psum(per_tok, axes)
        total = kbn_merge(per_doc, per_tok)
        return kbn_pack(kbn_add(
            total, e_pbeta + e_qbeta_ent + e_peta + e_qeta_ent))

    return highest_precision(elbo)


def scores(state: CTPFState, doc_mask=None) -> jax.Array:
    """Dense recommendation scores Eeta'·(Etheta+Eepsilon) (CTPF.jl:381-386).

    Returns [M_pad, U_seg]; one matmul instead of the reference's
    per-doc host loop.
    """
    Eeta = state.he / state.vav[:, None]                 # [K, U]
    Etheta = state.gimel / state.dalet[None, :]          # [M, K]
    Eeps = state.zayin / state.het[None, :]
    return (Etheta + Eeps) @ Eeta


def partition_spec(data_axis="data", vocab_axis: Optional[str] = None,
                   user_axis: Optional[str] = None):
    from jax.sharding import PartitionSpec as P

    alef_spec = P(None, vocab_axis) if vocab_axis is not None else P()
    he_spec = P(None, user_axis) if user_axis is not None else P()
    return CTPFState(
        alef=alef_spec, alef_old=alef_spec, bet=P(), bet_old=P(),
        gimel=P(data_axis), gimel_old=P(data_axis), dalet=P(), dalet_old=P(),
        he=he_spec, he_old=he_spec, vav=P(), vav_old=P(),
        zayin=P(data_axis), zayin_old=P(data_axis), het=P(), het_old=P(),
        elbo=P(),
    )
