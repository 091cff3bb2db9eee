"""Correlated topic model — batch-synchronous CAVI.

Redesign of the reference CTM (``src/CTM.jl``) and its OpenCL
twin (``src/gpuCTM.jl``).  The reference's heaviest machinery — a
per-document Newton step whose K×K solve runs as a workgroup-local
Gauss–Jordan with barrier sync inside an OpenCL kernel
(``CTM_LAMBDA_c``, gpuCTM.jl:258-337, with ``LINSOLVE_c`` from
utils.jl:60-90) — becomes a batched Cholesky solve vmapped over the doc
chunk (ops/newton.py: the reference's own comment at utils.jl:56-58
notes pivoting is unnecessary for SPD systems).  The per-coordinate
vsq Newton with back-tracking (``CTM_VSQ_c``, gpuCTM.jl:346-391)
vectorises elementwise over [B, K].

Global M-step: beta from segment-sums; mu/sigma from psum'd first and
second moments of lambda (sigma is computed with the *previous* mu,
matching the reference's update order update_sigma! → update_mu!,
CTM.jl:206-208).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.newton import ctm_lambda_newton, ctm_vsq_newton
from ..ops.packing import seg_loc_starts
from ..ops.segment import count_scatter
from ..utils.numerics import (
    EPSILON, aexp, alog, asoftmax, categorical_entropy, dirichlet_ones,
    highest_precision, kbn_add, kbn_merge, kbn_pack, kbn_psum, kbn_zero,
    l2norm, logsumexp, masked_fixpoint, mvnormal_diag_entropy,
)


class CTMState(NamedTuple):
    mu: jax.Array          # [K]
    sigma: jax.Array       # [K, K]
    invsigma: jax.Array    # [K, K]
    beta: jax.Array        # [K, V]
    beta_old: jax.Array    # [K, V]
    lam: jax.Array         # [M_pad, K]   (lambda)
    lam_old: jax.Array     # [M_pad, K]
    vsq: jax.Array         # [M_pad, K]
    logzeta: jax.Array     # [M_pad]
    elbo: jax.Array


def init(key: jax.Array, packed, K: int, dtype=jnp.float32) -> CTMState:
    """Constructor state (reference CTM.jl:27-52)."""
    M_pad, V = packed.M_pad, packed.V
    beta = dirichlet_ones(key, V, (K,)).astype(dtype)
    eye = jnp.eye(K, dtype=dtype)
    return CTMState(
        mu=jnp.zeros((K,), dtype), sigma=eye, invsigma=eye,
        beta=beta, beta_old=beta,
        lam=jnp.zeros((M_pad, K), dtype), lam_old=jnp.zeros((M_pad, K), dtype),
        vsq=jnp.ones((M_pad, K), dtype),
        logzeta=jnp.full((M_pad,), 0.5, dtype),
        elbo=jnp.zeros((2,), dtype),
    )


def _beta_rows(bt, row_sum):
    """Normalise beta rows, mapping a DEAD topic (zero statistic mass —
    reachable only in degenerate regimes, e.g. a Gaussian prior pushed
    past exp-underflow for every document; softmax phi is strictly
    positive in any sane state, so the guard never binds there) to the
    uniform row instead of 0/0 = NaN, which would poison every OTHER
    topic's phi via log(beta) on the next sweep (ref: the reference's
    own large-mu overflow, todo.txt:8/11, has no analogue guard)."""
    V = bt.shape[1]
    return jnp.where(row_sum > 0, bt / row_sum,
                     jnp.asarray(1.0, bt.dtype) / V)


def _phi(logbeta_d, lam, softmax=jax.nn.softmax):
    """phi ∝ exp(log beta[:,terms] + lambda), over K (CTM.jl:175-178)."""
    return softmax(logbeta_d + lam[:, None, :], axis=-1)


@highest_precision
def _estep_chunk(logbetaT, mu, invsigma, terms, counts, doc_mask,
                 lam, lam_old, vsq, logzeta, viter, vtol, niter, ntol, V,
                 seq_axis=None):
    """With ``seq_axis`` each document's token axis is sharded over that
    mesh axis (SP analogue, SURVEY §5.7b): phi rows live shard-local and
    the per-doc token reductions (C and phi@counts, the inputs of the
    lambda/vsq Newtons, CTM.jl:129-165) are psums over the shards; the
    Newtons themselves then run identically on every shard."""
    dtype = lam.dtype
    C = jnp.sum(counts, axis=-1)  # per-doc token totals (CTM.jl C field)
    if seq_axis is not None:
        C = jax.lax.psum(C, seq_axis)
    # zero-count (padded) slots may gather an all-zero beta column (unused
    # vocab id 0) whose raw log is -inf for every k; the K-softmax would be
    # NaN. Every use of phi is count-weighted, so neutralising those logits
    # is exact.
    logbeta_d = jnp.where(counts[..., None] > 0, logbetaT[terms], 0.0)  # [B, L, K]
    active0 = doc_mask > 0
    isd = jnp.diagonal(invsigma)

    def body(_, carry):
        lam, lam_old, vsq, logzeta, active = carry
        # update_phi! (CTM.jl:175-178)
        p = _phi(logbeta_d, lam)
        # update_logzeta! (CTM.jl:169-171)
        lz_new = logsumexp(lam + 0.5 * vsq, axis=-1)
        logzeta2 = jnp.where(active, lz_new, logzeta)
        # update_vsq! (CTM.jl:146-165)
        vsq2 = ctm_vsq_newton(lam, vsq, logzeta2, C, isd, active, niter, ntol)
        vsq2 = jnp.where(active[:, None], vsq2, vsq)
        # update_lambda! (CTM.jl:129-142); phi @ counts fixed during Newton
        pc = jnp.einsum("bl,blk->bk", counts, p, preferred_element_type=dtype)
        if seq_axis is not None:
            pc = jax.lax.psum(pc, seq_axis)
        lam_new = ctm_lambda_newton(lam, vsq2, logzeta2, pc, C, mu, invsigma,
                                    active, niter, ntol)
        lam_old2 = jnp.where(active[:, None], lam, lam_old)
        lam2 = jnp.where(active[:, None], lam_new, lam)
        # break: ‖lambda − lambda_old‖ < vtol (CTM.jl:200)
        active2 = active & (l2norm(lam2 - lam_old2) >= vtol)
        return lam2, lam_old2, vsq2, logzeta2, active2

    lam, lam_old, vsq, logzeta, _ = masked_fixpoint(
        body, (lam, lam_old, vsq, logzeta, active0), viter)

    # M-step stat with the last phi = f(beta, lambda_old) (CTM.jl:93, 122-125)
    p = _phi(logbeta_d, lam_old)
    w = p * counts[..., None]
    beta_temp = count_scatter(w.reshape(-1, w.shape[-1]), terms.reshape(-1), V)
    dm = doc_mask[:, None]
    vsq_sum = jnp.sum(vsq * dm, axis=0)                       # Σ_d vsq_d
    lam_sum = jnp.sum(lam * dm, axis=0)                       # Σ_d λ_d
    lam_outer = jnp.einsum("bi,bj->ij", lam * dm, lam)        # Σ_d λλᵀ
    return lam, lam_old, vsq, logzeta, beta_temp, vsq_sum, lam_sum, lam_outer


def make_step(packed, K: int, viter: int, vtol: float, niter: int, ntol: float,
              chunk_docs: int, axis_name=None,
              vocab_axis: Optional[str] = None, seq_axis: Optional[str] = None,
              identify: bool = False):
    """One CAVI sweep.  ``vocab_axis`` shards beta *storage* over that
    mesh axis exactly like LDA's TP mode (models/lda.py): all_gather in,
    reduce_scatter + replicated row-sum psum out; include the vocab axis
    in ``axis_name`` and shard docs over both axes.  ``seq_axis`` shards
    every document's token axis (SP analogue); incompatible with
    bucketed packing, like models/lda.py.

    ``identify=True`` applies the projection normalisation the
    reference's todo.txt:25 / issue #14 propose but never implemented:
    the logistic-normal has K−1 degrees of freedom (softmax only sees
    λ_i − λ_j), so plain CAVI gauge-fixes ITSELF — one coordinate's λ
    contracts to a deterministic reference level (measured here: its
    σ eigenvalue decays ~1/iter without bound, σ's condition number
    1.6e4 → 5.7e5 over 100→1000 iterations on a planted K=4 corpus)
    until invσ is numerically singular.  The projection pins the gauge
    explicitly each M-step: μ ← Pμ and σ ← PσP + 11ᵀ/K with
    P = I − 11ᵀ/K (unit variance, mean zero along the unidentified
    1-direction), which bounds uᵀσu ≥ (uᵀ1)²/K so σ can never go
    singular through the gauge channel.  Default OFF: the unprojected
    update is the reference's exact semantics (oracle parity)."""
    V = packed.V
    seg_starts = seg_loc_starts(packed)
    if seq_axis is not None:
        assert seg_starts is None, "token-axis sharding requires dense packing"

    def step(state: CTMState, terms, counts, doc_mask, M_total):
        dt = state.beta.dtype
        if vocab_axis is not None:
            beta_full = jax.lax.all_gather(state.beta, vocab_axis, axis=1,
                                           tiled=True)
        else:
            beta_full = state.beta
        logbetaT = jnp.log(beta_full).T  # raw log, matching CTM.jl:177

        def scan_body_xla(carry, xs):
            bt, vs, ls, lo = carry
            t, c, dm, la, lao, v, lz = xs
            la2, lao2, v2, lz2, bti, vsi, lsi, loi = _estep_chunk(
                logbetaT, state.mu, state.invsigma, t, c, dm,
                la, lao, v, lz, viter, vtol, niter, ntol, V,
                seq_axis=seq_axis,
            )
            return (bt + bti, vs + vsi, ls + lsi, lo + loi), (la2, lao2, v2, lz2)

        def sweep(t_arr, c_arr, dm_arr, la_a, lao_a, v_a, lz_a, carry):
            n_rows = t_arr.shape[0]
            B = min(chunk_docs, n_rows)
            n_chunks = n_rows // B
            body = scan_body_xla
            sh = lambda a: a.reshape((n_chunks, B) + a.shape[1:])
            carry, ys = jax.lax.scan(
                body, carry,
                (sh(t_arr), sh(c_arr), sh(dm_arr),
                 sh(la_a), sh(lao_a), sh(v_a), sh(lz_a)),
            )
            unsh = lambda a: a.reshape((n_rows,) + a.shape[2:])
            return carry, tuple(unsh(y) for y in ys)

        carry = (jnp.zeros((V, K), dt), jnp.zeros((K,), dt),
                 jnp.zeros((K,), dt), jnp.zeros((K, K), dt))
        if seg_starts is None:
            carry, (lam, lam_old, vsq, logzeta) = sweep(
                terms, counts, doc_mask, state.lam, state.lam_old,
                state.vsq, state.logzeta, carry)
        else:
            parts = []
            for lo0, t_arr, c_arr, dm_arr in zip(seg_starts, terms, counts, doc_mask):
                lo_, hi_ = lo0, lo0 + t_arr.shape[0]
                carry, ys = sweep(
                    t_arr, c_arr, dm_arr, state.lam[lo_:hi_],
                    state.lam_old[lo_:hi_], state.vsq[lo_:hi_],
                    state.logzeta[lo_:hi_], carry)
                parts.append(ys)
            lam, lam_old, vsq, logzeta = (
                jnp.concatenate([p_[i] for p_ in parts], axis=0)
                for i in range(4))
        beta_temp, vsq_sum, lam_sum, lam_outer = carry

        if axis_name is not None:
            # doc-level moments: data axes only (identical on seq shards)
            vsq_sum = jax.lax.psum(vsq_sum, axis_name)
            lam_sum = jax.lax.psum(lam_sum, axis_name)
            lam_outer = jax.lax.psum(lam_outer, axis_name)

        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name or ())
        # the beta stat is token-local: sum token shards too
        axes_tok = axes + (seq_axis,) if seq_axis is not None else axes
        # update_beta! reset (CTM.jl:114-118)
        if vocab_axis is not None:
            from ..parallel.shard import tp_normalize_rows

            bt_local, row_sum = tp_normalize_rows(beta_temp, vocab_axis, axes_tok)
            beta_new = _beta_rows(bt_local.T, row_sum[:, None])
        else:
            if axes_tok:
                beta_temp = jax.lax.psum(beta_temp, axes_tok)
            bt = beta_temp.T
            beta_new = _beta_rows(bt, jnp.sum(bt, axis=1, keepdims=True))
        # update_sigma! with previous mu (CTM.jl:108-111; order CTM.jl:206-208):
        # Σ_d (λ−μ)(λ−μ)ᵀ = Σλλᵀ − μΣλᵀ − Σλ μᵀ + M μμᵀ
        mu_old = state.mu
        centered = (
            lam_outer
            - jnp.outer(mu_old, lam_sum) - jnp.outer(lam_sum, mu_old)
            + M_total * jnp.outer(mu_old, mu_old)
        )
        sigma = (jnp.diag(vsq_sum) + centered) / M_total
        sigma = 0.5 * (sigma + sigma.T)
        # update_mu! (CTM.jl:102-104)
        mu_new = lam_sum / M_total
        if identify:
            dt = sigma.dtype
            ones_K = jnp.full((K, K), 1.0 / K, dt)      # 11ᵀ/K
            Pg = jnp.eye(K, dtype=dt) - ones_K          # sum-zero projector
            sigma = Pg @ sigma @ Pg + ones_K
            sigma = 0.5 * (sigma + sigma.T)
            mu_new = mu_new - jnp.mean(mu_new)
        invsigma = jnp.linalg.inv(sigma)
        invsigma = 0.5 * (invsigma + invsigma.T)

        return CTMState(
            mu=mu_new, sigma=sigma, invsigma=invsigma,
            beta=beta_new, beta_old=state.beta,
            lam=lam, lam_old=lam_old, vsq=vsq, logzeta=logzeta, elbo=state.elbo,
        )

    return highest_precision(step)


def make_elbo(packed, K: int, chunk_docs: int, axis_name=None,
              vocab_axis: Optional[str] = None, seq_axis: Optional[str] = None):
    """ELBO (CTM.jl:55-98): phi recomputed from (beta_old, lambda_old)."""
    V = packed.V
    seg_starts = seg_loc_starts(packed)
    if seq_axis is not None:
        assert seg_starts is None, "token-axis sharding requires dense packing"

    def elbo(state: CTMState, terms, counts, doc_mask):
        dt = state.beta.dtype
        eps = jnp.asarray(EPSILON, dt)
        if vocab_axis is not None:
            beta_full = jax.lax.all_gather(state.beta, vocab_axis, axis=1, tiled=True)
            beta_old_full = jax.lax.all_gather(state.beta_old, vocab_axis, axis=1, tiled=True)
        else:
            beta_full, beta_old_full = state.beta, state.beta_old
        logbeta_oldT = alog(beta_old_full).T           # CTM.jl:93 (raw)
        logbetaT = alog(beta_full + eps).T             # CTM.jl:71 (@boink)
        mu, invsigma = state.mu, state.invsigma
        # logdet(invsigma) via Cholesky (SPD)
        chol = jnp.linalg.cholesky(state.invsigma)
        logdet_inv = 2.0 * jnp.sum(alog(jnp.diagonal(chol)))
        log2pi = jnp.log(2.0 * jnp.pi)
        isd = jnp.diagonal(invsigma)

        # one combined [V, 2K] table: both per-token gathers pay their
        # per-row cost once (same trick as models/lda.py make_elbo)
        log_tabT = jnp.concatenate([logbeta_oldT, logbetaT], axis=1)

        def scan_body(acc, xs):
            acc_doc, acc_tok = acc
            t, c, dm, la, lao, v, lz = xs
            lt = log_tabT[t]                                   # [B, L, 2K]
            cd = jnp.sum(c, axis=-1)
            # phi from (beta_old, lambda_old) (CTM.jl:93); terms below use
            # the *current* lambda (CTM.jl:56-66). Zero-count slots masked as
            # in _estep_chunk.
            p = _phi(jnp.where(c[..., None] > 0, lt[..., :K], 0.0), lao,
                     softmax=asoftmax)
            pc = jnp.einsum("bl,blk->bk", c, p, preferred_element_type=dt)
            if seq_axis is not None:
                cd = jax.lax.psum(cd, seq_axis)
                pc = jax.lax.psum(pc, seq_axis)
            # Elogpeta (CTM.jl:56-59)
            diff = la - mu
            quad = jnp.einsum("bi,ij,bj->b", diff, invsigma, diff)
            e_peta = 0.5 * (logdet_inv - K * log2pi - jnp.sum(isd * v, -1) - quad)
            # Elogpz (CTM.jl:62-66)
            bound = jnp.sum(aexp(la + 0.5 * v - lz[:, None]), -1) + lz - 1.0
            e_pz = jnp.sum(pc * la, -1) - cd * bound
            # Elogpw (CTM.jl:69-73)
            e_pw = jnp.sum(p * lt[..., K:] * c[..., None], axis=(1, 2))
            # −Elogqeta = +entropy(MvNormal(λ, diag(vsq))) (CTM.jl:76-79)
            e_qeta = mvnormal_diag_entropy(v)
            # −Elogqz (CTM.jl:82-86)
            e_qz = jnp.sum(categorical_entropy(p) * c, axis=-1)
            # doc-level vs token-local terms in separate accumulators
            acc_doc = kbn_add(acc_doc, jnp.sum(dm * (e_peta + e_pz + e_qeta)))
            acc_tok = kbn_add(acc_tok, jnp.sum(dm * (e_pw + e_qz)))
            return (acc_doc, acc_tok), None

        def sweep(t_arr, c_arr, dm_arr, la_a, lao_a, v_a, lz_a, acc):
            n_rows = t_arr.shape[0]
            B = min(chunk_docs, n_rows)
            n_chunks = n_rows // B
            sh = lambda x: x.reshape((n_chunks, B) + x.shape[1:])
            acc, _ = jax.lax.scan(
                scan_body, acc,
                (sh(t_arr), sh(c_arr), sh(dm_arr),
                 sh(la_a), sh(lao_a), sh(v_a), sh(lz_a)),
            )
            return acc

        acc = (kbn_zero(dt), kbn_zero(dt))
        if seg_starts is None:
            acc = sweep(terms, counts, doc_mask, state.lam, state.lam_old,
                        state.vsq, state.logzeta, acc)
        else:
            for lo0, t_arr, c_arr, dm_arr in zip(seg_starts, terms, counts, doc_mask):
                lo_, hi_ = lo0, lo0 + t_arr.shape[0]
                acc = sweep(t_arr, c_arr, dm_arr, state.lam[lo_:hi_],
                            state.lam_old[lo_:hi_], state.vsq[lo_:hi_],
                            state.logzeta[lo_:hi_], acc)
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


def partition_spec(data_axis="data", vocab_axis: Optional[str] = None):
    from jax.sharding import PartitionSpec as P

    beta_spec = P(None, vocab_axis) if vocab_axis is not None else P()
    return CTMState(
        mu=P(), sigma=P(), invsigma=P(), beta=beta_spec, beta_old=beta_spec,
        lam=P(data_axis), lam_old=P(data_axis), vsq=P(data_axis),
        logzeta=P(data_axis), elbo=P(),
    )


def topicdist(state: CTMState, d=None) -> jax.Array:
    """softmax(lambda + vsq/2) (reference modelutils.jl:953-958)."""
    lam = state.lam if d is None else state.lam[d]
    vsq = state.vsq if d is None else state.vsq[d]
    x = lam + 0.5 * vsq
    return jax.nn.softmax(x, axis=-1)
