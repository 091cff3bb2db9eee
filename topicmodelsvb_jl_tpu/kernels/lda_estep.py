"""Fused LDA E-step kernel for NVIDIA Hopper (Pallas, Triton route).

Replaces the reference's gpuLDA inner-loop kernel set
(``LDA_PHI_c``/``LDA_PHI_NORM_c``/``LDA_GAMMA_c``/``LDA_ELOGTHETA_c``,
gpuLDA.jl:206-333).  Where the reference launches 4+ OpenCL kernels per
inner iteration, each round-tripping device memory, one program here
gathers its documents' ``(beta+eps)[:, terms]`` rows once, straight from
the ``[V, Kp]`` table, keeps them in registers across the *entire* viter
fixpoint (LDA.jl:171-179), and then emits the final ``phi .* counts``
sufficient-statistic rows for the M-step scatter (LDA.jl:129-132).  The
``[B, L, Kp]`` tile is never written to device memory; XLA cannot fuse
across ``while_loop`` iterations, so its body re-reads the tile on every
fixpoint pass.

Two numerical choices, both taken from the reference itself:

* phi is computed **multiplicatively** — ``phi ∝ beta[:, terms] .*
  exp(Elogtheta)`` with an EPSILON underflow guard — exactly the CPU
  reference's update (LDA.jl:150-154 under ``@positive``), not in log
  space.  The only transcendental per inner iteration is ``exp`` on the
  small [docs, Kp] Elogtheta tile.
* digamma is computed in-kernel with the shifted asymptotic series, the
  same construction as the reference's OpenCL ``DIGAMMA_c``
  (utils.jl:21-53).

Per-document convergence masking reproduces the reference's per-doc
``break`` (LDA.jl:175): a converged document's state freezes while the
rest of its program's documents keep iterating, and the program exits
once all of them have converged.

Triton tensors must have power-of-two sizes, so the token axis (a
multiple of 8 under bucketed packing) is walked in power-of-two
sub-tiles of ``lb`` slots; every sub-tile is loaded once and stays
resident for the whole fixpoint.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..utils.numerics import EPSILON

# Register budget of one program's resident [bt, L, Kp] f32 tile, in
# elements.  Past it the tile spills to local memory and the kernel
# loses its point; such segments take the XLA body (see choose_estep).
TILE_BUDGET = 32 * 1024
# resident tile elements per thread before a program takes more warps
ELEMS_PER_THREAD = 256


def round_up_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def padded_topics(K: int) -> int:
    """Topic lanes of the kernel's tiles (a power of two, at least 16)."""
    return max(16, round_up_pow2(K))


def _sub_tile(L: int) -> int:
    """Largest power-of-two sub-tile (≤ 32 slots) dividing ``L``."""
    lb = 1
    while lb < 32 and L % (lb * 2) == 0:
        lb *= 2
    return lb


def launch_config(L: int, Kp: int) -> tuple:
    """(docs per program, warps per program) for token width ``L``.

    One document per program and the fewest warps (a power of two, as
    Triton requires) that hold its tile at ≤ ELEMS_PER_THREAD elements
    per thread: measured on an H100 at NSF widths 88-256, K=100, against
    2-4 docs per program and 2-16 warps (PERF.md), fewer warps win —
    the per-token reductions then stay within a warp.
    """
    warps = 2
    while warps < 8 and L * Kp > warps * 32 * ELEMS_PER_THREAD:
        warps *= 2
    return 1, warps


def fits(L: int, Kp: int) -> bool:
    """True when a one-document tile of ``L`` token slots fits the budget."""
    return L * Kp <= TILE_BUDGET


def choose_estep(K: int, L: int, *, backend: str, use_pallas=None,
                 elogtheta_f64: bool = False, seq_axis=None,
                 vocab_routed: bool = False) -> bool:
    """The one place that decides which LDA E-step body runs on a segment.

    Returns True for the fused kernel, False for the XLA body.  The
    kernel is never used where it cannot compute the same thing: under
    ``elogtheta_f64`` (its digamma series is f32), token-axis sharding
    (``seq_axis``: the per-doc reduction is a psum across devices) and
    routed vocab-TP (likewise); nor for a segment whose tile would not
    fit the register budget.  ``use_pallas=None`` is the automatic
    choice: on for a GPU backend and K ≥ 64 (below that the topic-lane
    padding outweighs the fused fixpoint's saving).  ``True`` forces
    the kernel wherever it can run (tests and the on-card parity check,
    which pass ``interpret`` off the card); ``False`` forces the XLA
    body.
    """
    if use_pallas is False or elogtheta_f64 or seq_axis is not None \
            or vocab_routed or L % 8 or not fits(L, padded_topics(K)):
        return False
    if use_pallas is None:
        return backend == "gpu" and K >= 64
    return True


def digamma_series(x: jax.Array) -> jax.Array:
    """ψ(x) for x > 0 via recurrence + asymptotic series (f32-accurate).

    ψ(x) = ψ(x+8) − Σ_{i=0..7} 1/(x+i);  for t ≥ 8:
    ψ(t) ≈ ln t − 1/(2t) − 1/(12t²) + 1/(120t⁴) − 1/(252t⁶).
    Truncation error at t=8 is ~2.5e-10 — below f32 resolution.  Same
    construction as the reference's OpenCL ``DIGAMMA_c`` (utils.jl:21-53).
    """
    acc = jnp.zeros_like(x)
    for i in range(8):
        acc = acc + 1.0 / (x + float(i))
    t = x + 8.0
    inv = 1.0 / t
    inv2 = inv * inv
    series = (
        jnp.log(t) - 0.5 * inv
        - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 * (1.0 / 252.0)))
    )
    return series - acc


def _estep_kernel(betaT_ref, terms_ref, counts_ref, mask_ref, alpha_ref,
                  gamma_ref, el_ref, elo_ref,
                  gamma_out, el_out, elo_out, w_out,
                  *, viter: int, vtol: float, n_topics: int, lb: int):
    """One group of documents: viter fixpoint + final M-step stat rows."""
    L = terms_ref.shape[1]
    subs = [pl.ds(j * lb, lb) for j in range(L // lb)]
    # gather (beta+eps)[:, terms] once; each [bt, lb, Kp] sub-tile stays
    # resident for the whole fixpoint (0 on padded topic lanes)
    tiles = [betaT_ref[terms_ref[:, s], :] for s in subs]
    counts = [counts_ref[:, s] for s in subs]          # 0 on padded slots
    alpha = alpha_ref[:][None, :]                      # [1, Kp]
    eps = jnp.float32(EPSILON)
    kp = alpha.shape[-1]
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, kp), 1)
    # padded-topic lanes are pinned to Elogtheta = 0 so they never move
    # the per-doc convergence distance
    kmask = (lane < n_topics).astype(jnp.float32)
    is_last = (lane == kp - 1).astype(jnp.float32)
    vtol2 = jnp.float32(vtol) * jnp.float32(vtol)

    def gamma_stat(e):
        # phi ∝ (beta[:,terms]+eps) .* exp(Elogtheta) (LDA.jl:150-154) is
        # never materialised: per token slot the normaliser
        #   s_l = Σ_k beta_d[l,k]·e[k],
        # then the gamma statistic q_k = Σ_l (c_l/s_l)·beta_d[l,k]
        q = jnp.zeros(e.shape, jnp.float32)
        for bd, c in zip(tiles, counts):
            s = jnp.sum(bd * e[:, None, :], axis=-1)             # [bt, lb]
            q = q + jnp.sum(bd * (c / s)[:, :, None], axis=1)   # [bt, Kp]
        return q

    def body(carry):
        i, gamma, el, elo, active = carry              # active: [bt, 1] f32
        e = jnp.exp(el)
        gamma_new = alpha + e * gamma_stat(e) + eps    # LDA.jl:143-146
        # update_Elogtheta! (LDA.jl:136-139) with one digamma evaluation:
        # the row sum rides in the last padded lane when there is one
        gsum = jnp.sum(gamma_new * kmask, axis=-1, keepdims=True)
        if n_topics < kp:
            dg = digamma_series(gamma_new * (1.0 - is_last) + gsum * is_last)
            dg_sum = jnp.sum(dg * is_last, axis=-1, keepdims=True)
        else:
            dg = digamma_series(gamma_new)
            dg_sum = digamma_series(gsum)
        el_new = (dg - dg_sum) * kmask
        upd = active > 0.0
        gamma2 = jnp.where(upd, gamma_new, gamma)
        elo2 = jnp.where(upd, el, elo)
        el2 = jnp.where(upd, el_new, el)
        # per-doc break: ‖ΔElogtheta‖ < vtol (LDA.jl:175), squared form
        d = el2 - elo2
        dist2 = jnp.sum(d * d, axis=-1, keepdims=True)
        active2 = jnp.where(dist2 >= vtol2, active, 0.0)
        return i + 1, gamma2, el2, elo2, active2

    def cond(carry):
        i, _, _, _, active = carry
        return (i < viter) & (jnp.sum(active) > 0.0)

    active0 = mask_ref[:][:, None]                     # [bt, 1] 1.0 = real doc
    _, gamma, el, elo, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), gamma_ref[:], el_ref[:], elo_ref[:],
                     active0))

    gamma_out[:] = gamma
    el_out[:] = el
    elo_out[:] = elo
    # the M-step stat uses phi(beta, Elogtheta_old) — the value phi held
    # when the doc's fixpoint stopped (same warm-start identity as LDA.jl:87)
    e = jnp.exp(elo)
    for s, bd, c in zip(subs, tiles, counts):
        norm = jnp.sum(bd * e[:, None, :], axis=-1)
        w_out[:, s, :] = bd * (e[:, None, :] * (c / norm)[:, :, None])


def lda_estep(betaT, terms, counts, doc_mask, alpha, gamma, El, El_old, *,
              viter: int, vtol: float, n_topics: int,
              interpret: bool = False):
    """Run the fused E-step over a chunk of documents.

    Args (topic axis padded to Kp = :func:`padded_topics`):
      betaT:    [V, Kp]  (beta+EPSILON) transposed; 0 on padded topics
      terms:    [B, L]   int32 vocab ids, L a multiple of 8
      counts:   [B, L]   token counts, 0 on padding
      doc_mask: [B]      1 for real documents
      alpha:    [Kp]     Dirichlet hyperparameter, 0 on padded topics
      gamma/El/El_old: [B, Kp] per-doc variational state, zero-padded
    Returns (gamma, El, El_old, w) with w = phi·counts [B, L, Kp].
    """
    V, Kp = betaT.shape
    B, L = terms.shape
    assert Kp == round_up_pow2(Kp) and L % 8 == 0, (Kp, L)
    bt, warps = launch_config(L, Kp)
    kern = functools.partial(_estep_kernel, viter=viter, vtol=vtol,
                             n_topics=n_topics, lb=_sub_tile(L))
    f32 = betaT.dtype
    out_shapes = (
        jax.ShapeDtypeStruct((B, Kp), f32),
        jax.ShapeDtypeStruct((B, Kp), f32),
        jax.ShapeDtypeStruct((B, Kp), f32),
        jax.ShapeDtypeStruct((B, L, Kp), f32),
    )
    rows = lambda *shp: pl.BlockSpec((bt,) + shp,
                                     lambda i: (i,) + (0,) * len(shp))
    return pl.pallas_call(
        kern,
        grid=(B // bt,),
        in_specs=[
            pl.BlockSpec((V, Kp), lambda i: (0, 0)),
            rows(L), rows(L), rows(),
            pl.BlockSpec((Kp,), lambda i: (0,)),
            rows(Kp), rows(Kp), rows(Kp),
        ],
        out_specs=(rows(Kp), rows(Kp), rows(Kp), rows(L, Kp)),
        out_shape=out_shapes,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps, num_stages=1),
        interpret=interpret,
        name="lda_estep",
    )(betaT, terms, counts, doc_mask, alpha, gamma, El, El_old)
