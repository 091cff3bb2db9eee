"""Latent Dirichlet allocation — batch-synchronous CAVI.

Redesign of the reference LDA (``src/LDA.jl``) and its OpenCL
twin (``src/gpuLDA.jl``).  Differences from the reference are purely
architectural:

* The per-document E-step fixpoint (LDA.jl:169-180) runs
  batch-synchronously over dense doc chunks with **per-document
  convergence masking**, which reproduces the CPU per-doc-sweep
  trajectory exactly: beta/alpha only change after the full sweep, so
  document updates within an outer iteration are independent.
* phi ([K, N_d] in the reference, materialised one doc at a time,
  LDA.jl:41) is never stored across iterations — it is recomputed from
  (beta, Elogtheta) inside the fused chunk body, exactly the warm-start
  identity the reference itself uses (macros.jl:128-132, LDA.jl:87).
* The streaming M-step accumulation ``beta_temp[:,terms] += phi .* counts'``
  (LDA.jl:129-132) becomes a scatter-add over vocab ids (replacing the
  gpuLDA inverted-index scatter, gpuLDA.jl:156-177; see ops/segment.py
  for its determinism).
* Sufficient statistics (beta_temp, Elogtheta_sum) are psum'd over the
  data-parallel mesh axis when one is given; alpha's interior-point
  Newton (LDA.jl:97-118) then runs replicated on device.

State is a NamedTuple pytree; all update functions are pure.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.lda_estep import choose_estep, lda_estep, padded_topics
from ..ops.newton import dirichlet_newton
from ..ops.packing import seg_loc_starts
from ..ops.segment import count_scatter, count_scatter_into
from ..utils.numerics import (
    EPSILON, alog, asoftmax, categorical_entropy, digamma,
    dirichlet_entropy, dirichlet_ones, finite, highest_precision, kbn_add,
    kbn_merge, kbn_pack, kbn_psum, kbn_zero, kbn_zeros, l2norm, lgamma,
    masked_fixpoint,
)


class LDAState(NamedTuple):
    alpha: jax.Array          # [K]
    beta: jax.Array           # [K, V] right-stochastic rows
    beta_old: jax.Array       # [K, V]
    gamma: jax.Array          # [M_pad, K]
    Elogtheta: jax.Array      # [M_pad, K]
    Elogtheta_old: jax.Array  # [M_pad, K]
    elbo: jax.Array           # compensated (hi, lo) bound, shape (2,)


def init(key: jax.Array, packed, K: int, dtype=jnp.float32) -> LDAState:
    """Constructor state (reference LDA.jl:24-47)."""
    M_pad, V = packed.M_pad, packed.V
    beta = dirichlet_ones(key, V, (K,))
    beta = beta.astype(dtype)
    # Elogtheta init: −γ_euler − ψ(K) (LDA.jl:38)
    # ψ(K) = −γ + H_{K−1} for integer K ⇒ el0 = −γ − ψ(K) = −H_{K−1};
    # computed host-side (no device round trip at construction)
    el0 = -sum(1.0 / i for i in range(1, K))
    Elogtheta = jnp.full((M_pad, K), jnp.asarray(el0, dtype), dtype)
    return LDAState(
        alpha=jnp.ones((K,), dtype),
        beta=beta,
        beta_old=beta,
        gamma=jnp.ones((M_pad, K), dtype),
        Elogtheta=Elogtheta,
        Elogtheta_old=Elogtheta,
        elbo=jnp.zeros((2,), dtype),
    )


# make_elbo's automatic gather_direct switch: the [V, 2K] table size
# past which the two factor tables are gathered per chunk instead.  A
# fixed guess kept from earlier hardware, not measured on the H100.
GATHER_DIRECT_BYTES = 6e9


def _phi(logbeta_d: jax.Array, Elogtheta: jax.Array,
         softmax=jax.nn.softmax) -> jax.Array:
    """phi ∝ beta[:,terms]·exp(Elogtheta), normalised over K (LDA.jl:150-154).

    Log-space softmax — identical in exact arithmetic to the reference's
    ``@positive phi = beta .* exp(Elogtheta); phi ./= sum`` but immune to
    exp underflow at f32.
    logbeta_d: [B, L, K]; Elogtheta: [B, K] → [B, L, K].
    ``softmax`` is swappable: the training step keeps the fast intrinsic
    softmax; the ELBO path passes numerics.asoftmax (~2-ULP exp).
    """
    return softmax(logbeta_d + Elogtheta[:, None, :], axis=-1)


@highest_precision
def _estep_chunk(
    logbetaT: jax.Array,   # [V, K] log(beta + EPS) transposed for gather
    alpha: jax.Array,      # [K]
    terms: jax.Array,      # [B, L]
    counts: jax.Array,     # [B, L]
    doc_mask: jax.Array,   # [B]
    gamma: jax.Array,      # [B, K]
    El: jax.Array,         # [B, K]
    El_old: jax.Array,     # [B, K]
    viter: int,
    vtol: float,
    V: int,
    seq_axis=None,
    beta_acc=None,
    elogtheta_f64: bool = False,
):
    """Fused per-chunk E-step: viter fixpoint + sufficient statistics.

    Mirrors LDA.jl:171-179 with per-doc masking; returns updated per-doc
    state plus this chunk's beta_temp [V, K] and Elogtheta_sum [K].

    With ``seq_axis`` the token axis of every document is sharded over
    that mesh axis (the long-document analogue of sequence parallelism,
    SURVEY §5.7b): phi rows live shard-local and the per-doc reduction
    ``phi @ counts`` (LDA.jl:145) is a psum over the doc's token shards.
    """
    eps = jnp.asarray(EPSILON, gamma.dtype)
    logbeta_d = logbetaT[terms]  # [B, L, K] — gathered once, reused all viter iters
    active0 = doc_mask > 0

    def body(_, carry):
        gamma, El, El_old, active = carry
        p = _phi(logbeta_d, El)
        # update_gamma! (LDA.jl:143-146): gamma = alpha + phi @ counts (+EPS)
        pc = jnp.einsum(
            "bl,blk->bk", counts, p, preferred_element_type=gamma.dtype
        )
        if seq_axis is not None:
            pc = jax.lax.psum(pc, seq_axis)
        gamma_new = alpha[None, :] + pc + eps
        # update_Elogtheta! (LDA.jl:136-139).  With elogtheta_f64 the
        # digamma channel runs in f64 on the tiny [B, K] tile and casts
        # back — the f32 training-noise lever of utils/config.py
        if elogtheta_f64:
            g64 = gamma_new.astype(jnp.float64)
            El_new = (digamma(g64)
                      - digamma(jnp.sum(g64, -1, keepdims=True))
                      ).astype(gamma.dtype)
        else:
            El_new = digamma(gamma_new) - digamma(jnp.sum(gamma_new, -1, keepdims=True))
        upd = active[:, None]
        gamma2 = jnp.where(upd, gamma_new, gamma)
        El_old2 = jnp.where(upd, El, El_old)
        El2 = jnp.where(upd, El_new, El)
        # per-doc break: ‖Elogtheta − Elogtheta_old‖ < vtol (LDA.jl:175)
        active2 = active & (l2norm(El2 - El_old2) >= vtol)
        return gamma2, El2, El_old2, active2

    gamma, El, El_old, _ = masked_fixpoint(
        body, (gamma, El, El_old, active0), viter)

    # final phi for the M-step stat is f(beta, Elogtheta_old) — the value
    # phi held when the doc's fixpoint stopped (same identity as LDA.jl:87).
    p = _phi(logbeta_d, El_old)
    w = p * counts[..., None]                      # [B, L, K]; padding has count 0
    if beta_acc is None:
        beta_temp = count_scatter(w.reshape(-1, w.shape[-1]), terms.reshape(-1), V)
    else:
        # scatter straight onto the scan carry (aliased in place by XLA)
        # instead of materialising a fresh [V, K] per chunk — the large-V
        # step cost lever (ops/segment.py:count_scatter_into)
        beta_temp = count_scatter_into(beta_acc, w.reshape(-1, w.shape[-1]),
                                       terms.reshape(-1))
    El_sum = jnp.sum(El * doc_mask[:, None], axis=0)
    return gamma, El, El_old, beta_temp, El_sum


def make_step(packed, K: int, viter: int, vtol: float, niter: int, ntol: float,
              chunk_docs: int, axis_name=None,
              use_pallas: Optional[bool] = None, pallas_interpret: bool = False,
              vocab_axis: Optional[str] = None, seq_axis: Optional[str] = None,
              elogtheta_f64: bool = False, vocab_routed: bool = False):
    """Build the jittable outer-iteration step (one full CAVI sweep).

    Local docs are scanned in chunks of ``chunk_docs``; beta_temp /
    Elogtheta_sum are psum'd over ``axis_name`` (str or tuple of axes)
    when given — the DP all-reduce of §2.3 of the survey, the workload's
    "gradient all-reduce".

    ``vocab_axis`` shards beta *storage* over that mesh axis (the TP
    component, SURVEY §2.3): state.beta arrives as a [K, V/n] shard, is
    all-gathered for the E-step (beta is frozen within a sweep), and the
    new beta is formed shard-local via psum_scatter of the sufficient
    statistic.  Compute stays fully data-parallel — include the vocab
    axis in ``axis_name`` and shard docs over both axes.

    ``seq_axis`` shards every document's token axis over that mesh axis
    (the sequence-parallel analogue for very long documents, SURVEY
    §5.7b); the per-doc gamma reduction becomes a per-viter psum.
    Incompatible with bucketed packing and the Pallas body.

    ``vocab_routed`` is the TP mode that divides per-device *work*, not
    just storage: ``packed`` must be an
    :class:`~..ops.packing.RoutedCorpus` (token slots grouped by the
    contiguous vocab block each device owns), ``terms``/``counts``
    arrive sharded ``P(data_axis, vocab_axis)``, and each device
    gathers from and scatters into only its LOCAL ``[V/n, K]`` beta
    shard — beta is never all-gathered, the stat scatter and the M-step
    normalize are O(V/n) per device, and the only added communication
    is the seq-style per-viter ``psum`` of the [B, K] doc stat over the
    vocab axis plus one [K] row-sum psum in the M-step.  Pass data
    axes only in ``axis_name`` (docs are replicated across the vocab
    axis; any ``vocab_axis`` entry is ignored for the doc-level stats).

    ``use_pallas`` selects the fused E-step kernel (kernels/lda_estep.py)
    over the pure-XLA fixpoint per segment, through
    :func:`~..kernels.lda_estep.choose_estep`: ``None`` is the automatic
    choice, ``True`` forces the kernel wherever it can run (with
    ``pallas_interpret`` off the card), ``False`` forces XLA.  Both
    bodies compute the same math.
    """
    V = packed.V
    seg_starts = seg_loc_starts(packed)
    if elogtheta_f64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "elogtheta_f64 requires jax_enable_x64 (set JAX_ENABLE_X64=1 "
            "or jax.config.update('jax_enable_x64', True)); without it "
            "the f64 promotion would silently stay f32.")
    if seq_axis is not None:
        assert seg_starts is None, "token-axis sharding requires dense packing"
    if vocab_routed:
        if vocab_axis is None:
            raise ValueError("vocab_routed requires a vocab_axis")
        if seq_axis is not None:
            raise ValueError("vocab_routed and seq_axis are exclusive "
                             "(routing already splits the token axis)")
        assert seg_starts is None, "routed corpora are dense layouts"
    use_kernel = functools.partial(
        choose_estep, K, backend=jax.default_backend(), use_pallas=use_pallas,
        elogtheta_f64=elogtheta_f64, seq_axis=seq_axis,
        vocab_routed=vocab_routed)
    # vocab extent of the local gather table / stat scatter: the shard
    # block under routing, the full vocabulary otherwise
    V_local = packed.Vs if vocab_routed else V
    # the per-viter [B, K] doc-stat reduction axis: the vocab axis under
    # routing (each shard holds only its tokens), seq_axis under SP
    tok_axis = vocab_axis if vocab_routed else seq_axis

    def step(state: LDAState, terms, counts, doc_mask, M_total):
        dtype = state.beta.dtype
        if vocab_routed:
            beta_full = state.beta   # the LOCAL [K, V/n] shard, never gathered
        elif vocab_axis is not None:
            beta_full = jax.lax.all_gather(
                state.beta, vocab_axis, axis=1, tiled=True)
        else:
            beta_full = state.beta
        logbetaT = jnp.log(beta_full + jnp.asarray(EPSILON, dtype)).T

        Kp = padded_topics(K)
        # (beta+eps) transposed and topic-padded for the kernel's in-kernel
        # gather (pad topics → 0 ⇒ phi_pad = 0): the kernel works
        # multiplicatively like the reference CPU path, with the @boink
        # EPSILON guard folded into the table
        padk = lambda a: jnp.pad(a, ((0, 0), (0, Kp - K)))
        betaT_p = padk(beta_full.T + jnp.asarray(EPSILON, dtype))
        alpha_p = jnp.pad(state.alpha, (0, Kp - K))

        def scan_body_kernel(carry, xs):
            beta_temp, El_sum = carry
            t, c, dm, g, el, elo = xs
            g2, el2, elo2, w = lda_estep(
                betaT_p, t, c, dm, alpha_p, padk(g), padk(el), padk(elo),
                viter=viter, vtol=vtol, n_topics=K,
                interpret=pallas_interpret,
            )
            g2, el2, elo2 = g2[:, :K], el2[:, :K], elo2[:, :K]
            beta_temp = count_scatter_into(
                beta_temp, w[..., :K].reshape(-1, K), t.reshape(-1))
            es = jnp.sum(el2 * dm[:, None], axis=0)
            return (beta_temp, kbn_add(El_sum, es)), (g2, el2, elo2)

        def scan_body_xla(carry, xs):
            beta_temp, El_sum = carry
            t, c, dm, g, el, elo = xs
            g2, el2, elo2, bt, es = _estep_chunk(
                logbetaT, state.alpha, t, c, dm, g, el, elo, viter, vtol,
                V_local, seq_axis=tok_axis, beta_acc=beta_temp,
                elogtheta_f64=elogtheta_f64,
            )
            return (bt, kbn_add(El_sum, es)), (g2, el2, elo2)

        def sweep(t_arr, c_arr, dm_arr, g_arr, el_arr, elo_arr, carry):
            n_rows = t_arr.shape[0]
            B = min(chunk_docs, n_rows)
            n_chunks = n_rows // B
            body = (scan_body_kernel if use_kernel(t_arr.shape[1])
                    else scan_body_xla)
            sh = lambda a: a.reshape((n_chunks, B) + a.shape[1:])
            carry, (gamma, El, El_old) = jax.lax.scan(
                body, carry,
                (sh(t_arr), sh(c_arr), sh(dm_arr),
                 sh(g_arr), sh(el_arr), sh(elo_arr)),
            )
            unsh = lambda a: a.reshape((n_rows,) + a.shape[2:])
            return carry, unsh(gamma), unsh(El), unsh(El_old)

        # Elogtheta_sum rides a compensated (hi, lo) carry: its chunk-
        # sequential f32 accumulation (relative ~5e-6 at |El_sum|~6e5)
        # is amplified by the alpha Newton and re-multiplied by El_sum
        # in the bound (see ops/newton.py dirichlet_newton)
        carry0 = (jnp.zeros((V_local, K), dtype), kbn_zeros((K,), dtype))
        if seg_starts is None:
            (beta_temp, El_sum), gamma, El, El_old = sweep(
                terms, counts, doc_mask,
                state.gamma, state.Elogtheta, state.Elogtheta_old, carry0)
        else:
            # length-bucketed sweep: one scan per equal-width segment,
            # each slicing its contiguous rows of the (local) doc state
            carry = carry0
            g_parts, el_parts, elo_parts = [], [], []
            for lo0, t_arr, c_arr, dm_arr in zip(seg_starts, terms, counts, doc_mask):
                lo = lo0
                hi = lo + t_arr.shape[0]   # local rows under shard_map
                carry, g2, el2, elo2 = sweep(
                    t_arr, c_arr, dm_arr,
                    state.gamma[lo:hi], state.Elogtheta[lo:hi],
                    state.Elogtheta_old[lo:hi], carry)
                g_parts.append(g2)
                el_parts.append(el2)
                elo_parts.append(elo2)
            beta_temp, El_sum = carry
            gamma = jnp.concatenate(g_parts, axis=0)
            El = jnp.concatenate(el_parts, axis=0)
            El_old = jnp.concatenate(elo_parts, axis=0)

        stat_axes = axis_name if axis_name is not None else ()
        if isinstance(stat_axes, str):
            stat_axes = (stat_axes,)
        if vocab_routed:
            # docs live on the data axes only; El/El_sum are replicated
            # across the vocab axis (the per-viter psum makes every
            # replica identical), so doc-level stats reduce over the
            # data axes alone
            stat_axes = tuple(ax for ax in stat_axes if ax != vocab_axis)
        if seq_axis is not None:
            # token-local scatters: sum token shards too (El_sum is
            # doc-level and identical across seq shards — data axes only)
            stat_axes_bt = stat_axes + (seq_axis,)
        else:
            stat_axes_bt = stat_axes
        if stat_axes:
            El_sum = kbn_psum(El_sum, stat_axes)

        # update_beta! reset (LDA.jl:121-125)
        if vocab_routed:
            # beta_temp is vocab-LOCAL — every term id lives on exactly
            # one shard, so there is nothing to reduce over the vocab
            # axis except the [K] per-topic row sums that make the rows
            # stochastic over the FULL vocabulary
            if stat_axes:
                beta_temp = jax.lax.psum(beta_temp, stat_axes)
            row_sum = jax.lax.psum(jnp.sum(beta_temp, axis=0), vocab_axis)
            beta_new = beta_temp.T / row_sum[:, None]
        elif vocab_axis is not None:
            from ..parallel.shard import tp_normalize_rows

            bt_local, row_sum = tp_normalize_rows(
                beta_temp, vocab_axis, stat_axes_bt)
            beta_new = bt_local.T / row_sum[:, None]
        else:
            if stat_axes_bt:
                beta_temp = jax.lax.psum(beta_temp, stat_axes_bt)
            beta_new = beta_temp.T / jnp.sum(beta_temp.T, axis=1, keepdims=True)
        # update_alpha! (LDA.jl:97-118), replicated on device; the lo
        # half of the compensated El_sum enters the Newton's mean-form
        # gradient at full precision (ops/newton.py)
        alpha_new = dirichlet_newton(state.alpha, El_sum[0], M_total,
                                     niter, ntol, Elogtheta_sum_lo=El_sum[1])

        return LDAState(
            alpha=alpha_new, beta=beta_new, beta_old=state.beta,
            gamma=gamma, Elogtheta=El, Elogtheta_old=El_old, elbo=state.elbo,
        )

    return highest_precision(step)


def estep_bodies(packed, K: int, use_pallas: Optional[bool] = None,
                 elogtheta_f64: bool = False) -> list:
    """Which E-step body :func:`make_step` runs on each segment of
    ``packed`` on the current backend: ``(width, rows, "kernel"|"xla")``."""
    segs = (packed.segments if packed.segments is not None else (packed,))
    out = []
    for s in segs:
        L = s.terms.shape[1]
        k = choose_estep(K, L, backend=jax.default_backend(),
                         use_pallas=use_pallas, elogtheta_f64=elogtheta_f64)
        out.append((L, int(s.terms.shape[0]), "kernel" if k else "xla"))
    return out


def make_elbo(packed, K: int, chunk_docs: int, axis_name=None,
              vocab_axis: Optional[str] = None, seq_axis: Optional[str] = None,
              gather_direct: Optional[bool] = None, vocab_routed: bool = False):
    """Build the jittable full-corpus ELBO (reference LDA.jl:50-93).

    phi is recomputed from (beta_old, Elogtheta_old) exactly as
    update_elbo! does (LDA.jl:83-93); the five terms use the *current*
    alpha/beta/gamma/Elogtheta, mirroring check_elbo! running after the
    M-step (modelutils.jl:574-585).

    ``gather_direct`` skips materialising the combined [V, 2K] log-beta
    table (the pass's dominant allocation at large V: 2 GB at V=2.5e6,
    K=100) and gathers the two [V, K] factor tables per chunk instead.
    ``None`` switches it on once the table alone would take more than
    ``GATHER_DIRECT_BYTES``.

    ``vocab_routed`` (with a :class:`~..ops.packing.RoutedCorpus` and
    token data sharded ``P(data, vocab)``): every table is built from
    the local [V/n, K] beta shard — nothing is all-gathered — and the
    token-level accumulator (including Elogpz, which is linear in the
    per-shard partial doc stat) psums over data axes + the vocab axis
    while the vocab-replicated doc-level terms psum over data axes only.
    """
    V = packed.V
    if vocab_routed and vocab_axis is None:
        raise ValueError("vocab_routed requires a vocab_axis")
    if vocab_routed and seq_axis is not None:
        raise ValueError("vocab_routed and seq_axis are exclusive")
    # under routing every table is built from the LOCAL [V/n, K] shard
    V_tab = packed.Vs if vocab_routed else V
    if gather_direct is None:
        # f64 states build an f64 table
        itemsize = np.dtype(packed.counts.dtype).itemsize
        gather_direct = V_tab * 2 * K * itemsize > GATHER_DIRECT_BYTES
    seg_starts = seg_loc_starts(packed)
    if seq_axis is not None:
        assert seg_starts is None, "token-axis sharding requires dense packing"

    def elbo(state: LDAState, terms, counts, doc_mask):
        eps = jnp.asarray(EPSILON, state.beta.dtype)
        if vocab_routed:
            # local shards: every gather/table stays [V/n, ·] per device
            beta_full, beta_old_full = state.beta, state.beta_old
        elif vocab_axis is not None:
            beta_full = jax.lax.all_gather(state.beta, vocab_axis, axis=1, tiled=True)
            beta_old_full = jax.lax.all_gather(state.beta_old, vocab_axis, axis=1, tiled=True)
        else:
            beta_full, beta_old_full = state.beta, state.beta_old
        logbeta_oldT = alog(beta_old_full + eps).T  # for phi recompute
        logbetaT = alog(beta_full + eps).T          # Elogpw uses current beta
        a = state.alpha
        # Elogptheta doc-constant part (LDA.jl:50-53)
        theta_const = finite(lgamma(jnp.sum(a))) - finite(jnp.sum(lgamma(a)))

        # one combined [V, 2K] table, gathered once per token slot; at
        # large V the combined copy is skipped and the two factors
        # gather per chunk
        if gather_direct:
            gather_log_tab = lambda t: jnp.concatenate(
                [logbeta_oldT[t], logbetaT[t]], axis=-1)
        else:
            log_tabT = jnp.concatenate([logbeta_oldT, logbetaT], axis=1)
            gather_log_tab = lambda t: log_tabT[t]

        def scan_body(acc, xs):
            acc_doc, acc_tok = acc
            t, c, dm, g, el, elo = xs
            lt = gather_log_tab(t)                               # [B, L, 2K]
            p = _phi(lt[..., :K], elo, softmax=asoftmax)         # [B, L, K]
            cw = c[..., None]
            # Elogptheta (LDA.jl:50-53)
            e_ptheta = theta_const + jnp.sum((a - 1.0) * el, -1)
            # Elogpz (LDA.jl:56-60): dot(phi @ counts, Elogtheta)
            pc = jnp.einsum("bl,blk->bk", c, p, preferred_element_type=p.dtype)
            if seq_axis is not None:
                pc = jax.lax.psum(pc, seq_axis)
            e_pz = jnp.sum(pc * el, -1)
            # Elogpw (LDA.jl:63-67): sum(phi .* log(beta[:,terms]) * counts)
            e_pw = jnp.sum(p * lt[..., K:] * cw, axis=(1, 2))
            # −Elogqtheta = +entropy(Dirichlet(gamma)) (LDA.jl:70-73)
            e_qtheta = dirichlet_entropy(g)
            # −Elogqz = +Σ c·entropy(Categorical(phi)) (LDA.jl:76-80)
            e_qz = jnp.sum(categorical_entropy(p) * c, axis=-1)
            # doc-level terms are replicated across token shards; token-
            # level terms are shard-local — kept in separate accumulators.
            # Under routing e_pz rides the token accumulator instead of a
            # per-chunk pc psum: dot(pc, El) is linear in pc and El is
            # replicated, so the shard partial sums add up exactly.
            if vocab_routed:
                acc_doc = kbn_add(acc_doc, jnp.sum(dm * (e_ptheta + e_qtheta)))
                acc_tok = kbn_add(acc_tok, jnp.sum(dm * (e_pz + e_pw + e_qz)))
            else:
                acc_doc = kbn_add(
                    acc_doc, jnp.sum(dm * (e_ptheta + e_pz + e_qtheta)))
                acc_tok = kbn_add(acc_tok, jnp.sum(dm * (e_pw + e_qz)))
            return (acc_doc, acc_tok), None

        def sweep(t_arr, c_arr, dm_arr, g_arr, el_arr, elo_arr, acc):
            n_rows = t_arr.shape[0]
            B = min(chunk_docs, n_rows)
            n_chunks = n_rows // B
            sh = lambda x: x.reshape((n_chunks, B) + x.shape[1:])
            acc, _ = jax.lax.scan(
                scan_body, acc,
                (sh(t_arr), sh(c_arr), sh(dm_arr),
                 sh(g_arr), sh(el_arr), sh(elo_arr)),
            )
            return acc

        # the bound rides a compensated (hi, lo) pair end to end — the
        # scan carry, the cross-shard reduction, and the (2,) return —
        # so the reference's tol=1.0 stopping (LDA.jl:161) is reachable
        # at corpus magnitudes where the f32 ulp alone exceeds tol (see
        # utils/numerics.py, compensated ELBO accumulation)
        acc = (kbn_zero(state.beta.dtype), kbn_zero(state.beta.dtype))
        if seg_starts is None:
            acc = sweep(terms, counts, doc_mask,
                        state.gamma, state.Elogtheta, state.Elogtheta_old,
                        acc)
        else:
            for lo0, t_arr, c_arr, dm_arr in zip(seg_starts, terms, counts, doc_mask):
                lo = lo0
                hi = lo + t_arr.shape[0]
                acc = sweep(t_arr, c_arr, dm_arr,
                            state.gamma[lo:hi], state.Elogtheta[lo:hi],
                            state.Elogtheta_old[lo:hi], acc)
        total_doc, total_tok = acc
        axes = axis_name if axis_name is not None else ()
        if isinstance(axes, str):
            axes = (axes,)
        if vocab_routed:
            # token terms sum over data axes AND the vocab shards; doc
            # terms are vocab-replicated — data axes only
            data_axes = tuple(ax for ax in axes if ax != vocab_axis)
            total_tok = kbn_psum(total_tok, data_axes + (vocab_axis,))
            total_doc = kbn_psum(total_doc, data_axes)
            return kbn_pack(kbn_merge(total_doc, total_tok))
        if seq_axis is not None:
            total_tok = kbn_psum(total_tok, axes + (seq_axis,))
            total_doc = kbn_psum(total_doc, axes)
            return kbn_pack(kbn_merge(total_doc, total_tok))
        return kbn_pack(kbn_psum(kbn_merge(total_doc, total_tok), axes))

    return highest_precision(elbo)


def partition_spec(data_axis="data", vocab_axis: Optional[str] = None):
    """shard_map PartitionSpecs: per-doc state sharded, globals replicated.

    ``data_axis`` may be a tuple of mesh axes (docs sharded over their
    product).  With ``vocab_axis`` beta/beta_old storage is sharded over
    that axis (TP; SURVEY §2.3) while everything else stays replicated.
    """
    from jax.sharding import PartitionSpec as P

    beta_spec = P(None, vocab_axis) if vocab_axis is not None else P()
    return LDAState(
        alpha=P(), beta=beta_spec, beta_old=beta_spec,
        gamma=P(data_axis), Elogtheta=P(data_axis), Elogtheta_old=P(data_axis),
        elbo=P(),
    )


def topicdist(state: LDAState, d=None) -> jax.Array:
    """Normalised gamma (reference modelutils.jl:946-951)."""
    g = state.gamma if d is None else state.gamma[d]
    return g / jnp.sum(g, axis=-1, keepdims=True)


def topics_ranking(beta) -> np.ndarray:
    """Top-terms permutation per topic (LDA.jl:189), 1-based like the reference."""
    b = np.asarray(beta)
    return np.argsort(-b, axis=1, kind="stable") + 1
