"""Fused LDA E-step kernel tests (Pallas Triton route, interpret mode here).

The fused E-step kernel must compute the same math as the pure-XLA
fixpoint path (models/lda.py:_estep_chunk) — the reference's own
CPU-vs-GPU relationship, where tolerance (not bitwise) agreement is the
criterion because the two paths order float ops differently
(LDA.jl:14-21 vs gpuLDA.jl:14-21).  The same comparison runs compiled
on the card in chip_smoke.py's kernel-parity phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topicmodelsvb_jl_tpu.kernels.lda_estep import (
    TILE_BUDGET, choose_estep, digamma_series, lda_estep, padded_topics,
)
from topicmodelsvb_jl_tpu.models import lda as lda_mod
from topicmodelsvb_jl_tpu.ops.packing import PackedCorpus


def _small_packed(M=32, V=64, L=32, seed=3):
    rng = np.random.default_rng(seed)
    terms = rng.integers(0, V, size=(M, L)).astype(np.int32)
    counts = (1 + rng.poisson(0.4, size=(M, L))).astype(np.float32)
    n = rng.integers(4, L, size=M)
    valid = np.arange(L)[None, :] < n[:, None]
    counts *= valid
    terms *= valid
    dm = np.ones(M, np.float32)
    dm[-3:] = 0.0  # padded docs
    counts[-3:] = 0.0
    return PackedCorpus(
        terms=terms, counts=counts, doc_mask=dm, N=n.astype(np.int32),
        C=counts.sum(1), M=M - 3, V=V, L=L, max_count=int(counts.max()),
    )


def test_digamma_series_matches_lax():
    x = jnp.asarray(
        np.concatenate([np.linspace(1e-3, 0.9, 50),
                        np.linspace(1.0, 50.0, 50),
                        np.linspace(100.0, 5e4, 20)]).astype(np.float32))
    got = digamma_series(x)
    want = jax.lax.digamma(x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


# two token widths: a power of two (one 32-slot sub-tile) and 24 slots
# (three 8-slot sub-tiles, the shape bucketed packing produces)
@pytest.mark.parametrize("L", [32, 24])
@pytest.mark.parametrize("K", [7, 16, 100])
def test_lda_estep_kernel_matches_xla(K, L):
    packed = _small_packed(L=L)
    state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float32)
    data = (
        jnp.asarray(packed.terms), jnp.asarray(packed.counts),
        jnp.asarray(packed.doc_mask), jnp.asarray(float(packed.M), jnp.float32),
    )
    kw = dict(viter=6, vtol=1.0 / K**2, niter=50, ntol=1.0 / K**2,
              chunk_docs=16, axis_name=None)
    step_x = jax.jit(lda_mod.make_step(packed, K, use_pallas=False, **kw))
    step_p = jax.jit(lda_mod.make_step(packed, K, use_pallas=True,
                                       pallas_interpret=True, **kw))
    sx, sp = state, state
    for _ in range(2):  # two outer iterations so differences compound
        sx = step_x(sx, *data)
        sp = step_p(sp, *data)
    for f in ("alpha", "beta", "gamma", "Elogtheta"):
        a = np.asarray(getattr(sx, f))
        b = np.asarray(getattr(sp, f))
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-5,
                                   err_msg=f"{f} diverged")


def test_lda_estep_padded_doc_rows_frozen():
    """Padded documents (mask 0) must keep their incoming state."""
    K = 8
    packed = _small_packed()
    state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float32)
    Kp = padded_topics(K)
    padk = lambda a: jnp.pad(jnp.asarray(a), ((0, 0), (0, Kp - K)))
    g, el, elo, w = lda_estep(
        padk(state.beta.T + 1e-30), jnp.asarray(packed.terms),
        jnp.asarray(packed.counts), jnp.asarray(packed.doc_mask),
        jnp.pad(state.alpha, (0, Kp - K)),
        padk(state.gamma), padk(state.Elogtheta), padk(state.Elogtheta_old),
        viter=4, vtol=1e-6, n_topics=K, interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(g)[-3:, :K],
                                  np.asarray(state.gamma)[-3:])
    np.testing.assert_array_equal(np.asarray(el)[-3:, :K],
                                  np.asarray(state.Elogtheta)[-3:])
    assert np.all(np.asarray(w)[-3:] == 0.0)
    assert w.shape == (packed.terms.shape[0], packed.L, Kp)


def test_lda_estep_bucketed_segments_match_xla():
    """A bucketed corpus runs the kernel once per segment width, each
    segment on its own rows of the per-doc state, in one sweep."""
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.ops.packing import bucketize_packed, pack_corpus

    K = 16
    corp = tm.synth_corpus(M=48, V=60, K=4, seed=5, mean_terms=12,
                           mean_tokens=20)
    packed = bucketize_packed(pack_corpus(corp, pad_multiple=8,
                                          docs_multiple=16),
                              chunk=16, pad_multiple=8)
    assert len(packed.segments) > 1
    state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float32)
    data = (tuple(jnp.asarray(s.terms) for s in packed.segments),
            tuple(jnp.asarray(s.counts) for s in packed.segments),
            tuple(jnp.asarray(s.doc_mask) for s in packed.segments),
            jnp.asarray(float(packed.M), jnp.float32))
    kw = dict(viter=5, vtol=1.0 / K**2, niter=50, ntol=1.0 / K**2,
              chunk_docs=16, axis_name=None)
    sx = jax.jit(lda_mod.make_step(packed, K, use_pallas=False, **kw))(
        state, *data)
    sp = jax.jit(lda_mod.make_step(packed, K, use_pallas=True,
                                   pallas_interpret=True, **kw))(state, *data)
    for f in ("beta", "gamma", "Elogtheta"):
        np.testing.assert_allclose(np.asarray(getattr(sx, f)),
                                   np.asarray(getattr(sp, f)),
                                   rtol=5e-3, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("K,expect", [(7, 16), (16, 16), (17, 32),
                                      (100, 128), (128, 128)])
def test_padded_topics_is_power_of_two(K, expect):
    assert padded_topics(K) == expect


_WIDE = TILE_BUDGET // 128 + 8     # one slot group past the K=100 budget


@pytest.mark.parametrize("kw,want", [
    (dict(backend="gpu"), True),                        # auto: GPU, K >= 64
    (dict(backend="cpu"), False),                       # auto: not on the CPU
    (dict(backend="gpu", K=32), False),                 # auto: small K
    (dict(backend="cpu", use_pallas=True), True),       # forced (interpret)
    (dict(backend="gpu", use_pallas=False), False),     # forced off
    (dict(backend="gpu", elogtheta_f64=True), False),   # f64 digamma channel
    (dict(backend="gpu", seq_axis="seq"), False),       # token-axis sharding
    (dict(backend="gpu", vocab_routed=True), False),    # routed vocab-TP
    (dict(backend="gpu", L=_WIDE), False),              # past the tile budget
    (dict(backend="gpu", use_pallas=True, L=_WIDE), False),
    (dict(backend="gpu", L=20), False),                 # width not a multiple of 8
])
def test_choose_estep_rules(kw, want):
    kw = dict(kw)
    K = kw.pop("K", 100)
    L = kw.pop("L", 96)
    assert choose_estep(K, L, **kw) is want


@pytest.mark.parametrize("L", [8, 88, 136, 256])
@pytest.mark.parametrize("Kp", [16, 128, 256])
def test_launch_config_warps_power_of_two(L, Kp):
    """Triton aborts on a warp count that is not a power of two (a width
    of 88 once gave 11)."""
    from topicmodelsvb_jl_tpu.kernels.lda_estep import launch_config

    docs, warps = launch_config(L, Kp)
    assert docs == 1 and 2 <= warps <= 8 and warps & (warps - 1) == 0
