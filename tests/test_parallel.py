"""TP (vocab-axis) and SP (token-axis) sharding equivalence tests.

The reference has no multi-device capability (SURVEY §2.3); these are
the build's first-class parallelism components, validated on the
8-virtual-device CPU mesh: every sharded configuration must reproduce
the single-device trajectory up to reduction-order roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topicmodelsvb_jl_tpu.utils.numerics import elbo_value
from jax.sharding import PartitionSpec as P

from topicmodelsvb_jl_tpu.models import lda as lda_mod
from topicmodelsvb_jl_tpu.ops.packing import PackedCorpus, unit_counts
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.parallel.shard import shard_map


def _packed(M=64, V=512, L=32, seed=0):
    rng = np.random.default_rng(seed)
    terms = rng.integers(0, V, size=(M, L)).astype(np.int32)
    counts = (1 + rng.poisson(0.4, size=(M, L))).astype(np.float64)
    n = rng.integers(8, L, size=M)
    valid = np.arange(L)[None, :] < n[:, None]
    counts *= valid
    terms *= valid
    return PackedCorpus(
        terms=terms, counts=counts, doc_mask=np.ones(M, np.float64),
        N=n.astype(np.int32), C=counts.sum(1), M=M, V=V, L=L,
        max_count=int(counts.max()),
    )


def _reference_run(packed, K, iters=3):
    state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    step = jax.jit(lda_mod.make_step(
        packed, K, viter=5, vtol=1.0 / K**2, niter=100, ntol=1.0 / K**2,
        chunk_docs=16, axis_name=None, use_pallas=False))
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask), jnp.asarray(float(packed.M), jnp.float64))
    for _ in range(iters):
        state = step(state, *data)
    elbo = jax.jit(lda_mod.make_elbo(packed, K, chunk_docs=16))(state, *data[:3])
    return state, elbo_value(elbo)


def test_vocab_axis_tp_matches_single_device():
    """beta sharded over a vocab axis (TP): same trajectory + ELBO."""
    K = 6
    packed = _packed()
    ref, ref_elbo = _reference_run(packed, K)

    mesh = make_mesh(axis_names=("data", "vocab"), shape=(2, 4))
    spec = lda_mod.partition_spec(data_axis=("data", "vocab"), vocab_axis="vocab")
    step_l = lda_mod.make_step(
        packed, K, viter=5, vtol=1.0 / K**2, niter=100, ntol=1.0 / K**2,
        chunk_docs=8, axis_name=("data", "vocab"), use_pallas=False,
        vocab_axis="vocab")
    elbo_l = lda_mod.make_elbo(
        packed, K, chunk_docs=8, axis_name=("data", "vocab"),
        vocab_axis="vocab")
    dspec = P(("data", "vocab"))
    step = jax.jit(shard_map(
        step_l, mesh=mesh, in_specs=(spec, dspec, dspec, dspec, P()),
        out_specs=spec, check_vma=False))
    elbo_fn = jax.jit(shard_map(
        elbo_l, mesh=mesh, in_specs=(spec, dspec, dspec, dspec),
        out_specs=P(), check_vma=False))

    state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask), jnp.asarray(float(packed.M), jnp.float64))
    for _ in range(3):
        state = step(state, *data)
    np.testing.assert_allclose(np.asarray(state.beta), np.asarray(ref.beta),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(state.gamma), np.asarray(ref.gamma),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(state.alpha), np.asarray(ref.alpha),
                               rtol=1e-7)
    e = elbo_value(elbo_fn(state, *data[:3]))
    np.testing.assert_allclose(e, ref_elbo, rtol=1e-9)


def test_vocab_routed_tp_matches_single_device():
    """Routed TP: tokens routed to the vocab shard that owns them — beta
    is never all-gathered, gathers/scatters/normalize are O(V/n) per
    device — must reproduce the single-device trajectory + ELBO."""
    from topicmodelsvb_jl_tpu.ops.packing import route_packed

    K = 6
    packed = _packed()
    ref, ref_elbo = _reference_run(packed, K)

    routed = route_packed(packed, n_shards=4, pad_multiple=8)
    # every real slot must survive routing with its count
    assert routed.counts.sum() == packed.counts.sum()
    assert routed.Vs * routed.n_shards == packed.V
    # routed ids are shard-local
    assert routed.terms.max() < routed.Vs

    mesh = make_mesh(axis_names=("data", "vocab"), shape=(2, 4))
    spec = lda_mod.partition_spec(data_axis="data", vocab_axis="vocab")
    step_l = lda_mod.make_step(
        routed, K, viter=5, vtol=1.0 / K**2, niter=100, ntol=1.0 / K**2,
        chunk_docs=16, axis_name="data", use_pallas=False,
        vocab_axis="vocab", vocab_routed=True)
    elbo_l = lda_mod.make_elbo(
        routed, K, chunk_docs=16, axis_name="data",
        vocab_axis="vocab", vocab_routed=True)
    tokspec = P("data", "vocab")   # docs over data, shard blocks over vocab
    dspec = P("data")
    step = jax.jit(shard_map(
        step_l, mesh=mesh,
        in_specs=(spec, tokspec, tokspec, dspec, P()),
        out_specs=spec, check_vma=False))
    elbo_fn = jax.jit(shard_map(
        elbo_l, mesh=mesh, in_specs=(spec, tokspec, tokspec, dspec),
        out_specs=P(), check_vma=False))

    state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    data = (jnp.asarray(routed.terms), jnp.asarray(routed.counts),
            jnp.asarray(routed.doc_mask),
            jnp.asarray(float(packed.M), jnp.float64))
    for _ in range(3):
        state = step(state, *data)
    np.testing.assert_allclose(np.asarray(state.beta), np.asarray(ref.beta),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(state.gamma), np.asarray(ref.gamma),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(state.alpha), np.asarray(ref.alpha),
                               rtol=1e-7)
    e = elbo_value(elbo_fn(state, *data[:3]))
    np.testing.assert_allclose(e, ref_elbo, rtol=1e-9)


def test_route_packed_layout():
    """route_packed: block ownership, local ids, per-doc mass preserved."""
    from topicmodelsvb_jl_tpu.ops.packing import route_packed

    packed = _packed(M=16, V=64, L=24, seed=7)
    routed = route_packed(packed, n_shards=4, pad_multiple=8)
    S, Ls, Vs = routed.n_shards, routed.Ls, routed.Vs
    assert routed.terms.shape == (packed.M_pad, S * Ls)
    for m in range(packed.M):
        # reconstruct this doc's (global id → count) bag from each layout
        orig = {}
        for t, c in zip(packed.terms[m], packed.counts[m]):
            if c > 0:
                orig[int(t)] = orig.get(int(t), 0.0) + float(c)
        got = {}
        for s in range(S):
            blk = slice(s * Ls, (s + 1) * Ls)
            for t, c in zip(routed.terms[m, blk], routed.counts[m, blk]):
                if c > 0:
                    g = int(t) + s * Vs     # local → global
                    assert s * Vs <= g < (s + 1) * Vs
                    got[g] = got.get(g, 0.0) + float(c)
        assert got == orig
    assert 0.0 < routed.fill <= 1.0
    with np.testing.assert_raises(ValueError):
        route_packed(packed, n_shards=5)   # 64 % 5 != 0


def test_seq_axis_sp_matches_single_device():
    """Token axis of every doc sharded over a seq axis (SP analogue)."""
    K = 6
    packed = _packed()
    ref, ref_elbo = _reference_run(packed, K)

    mesh = make_mesh(axis_names=("data", "seq"), shape=(2, 4))
    spec = lda_mod.partition_spec(data_axis="data")
    step_l = lda_mod.make_step(
        packed, K, viter=5, vtol=1.0 / K**2, niter=100, ntol=1.0 / K**2,
        chunk_docs=16, axis_name="data", use_pallas=False, seq_axis="seq")
    elbo_l = lda_mod.make_elbo(
        packed, K, chunk_docs=16, axis_name="data", seq_axis="seq")
    tokspec = P("data", "seq")   # docs over data, token axis over seq
    dspec = P("data")
    step = jax.jit(shard_map(
        step_l, mesh=mesh,
        in_specs=(spec, tokspec, tokspec, dspec, P()),
        out_specs=spec, check_vma=False))
    elbo_fn = jax.jit(shard_map(
        elbo_l, mesh=mesh, in_specs=(spec, tokspec, tokspec, dspec),
        out_specs=P(), check_vma=False))

    state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask), jnp.asarray(float(packed.M), jnp.float64))
    for _ in range(3):
        state = step(state, *data)
    np.testing.assert_allclose(np.asarray(state.beta), np.asarray(ref.beta),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(state.gamma), np.asarray(ref.gamma),
                               rtol=1e-6)
    e = elbo_value(elbo_fn(state, *data[:3]))
    np.testing.assert_allclose(e, ref_elbo, rtol=1e-9)


def test_ctm_vocab_axis_tp_matches_single_device():
    """CTM with beta storage sharded over a vocab axis (TP)."""
    from topicmodelsvb_jl_tpu.models import ctm as ctm_mod

    K = 4
    packed = _packed(M=32, V=256, L=16, seed=4)
    # single-device reference
    st = ctm_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    step1 = jax.jit(ctm_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        chunk_docs=8, axis_name=None))
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask), jnp.asarray(float(packed.M), jnp.float64))
    ref = st
    for _ in range(2):
        ref = step1(ref, *data)

    mesh = make_mesh(axis_names=("data", "vocab"), shape=(2, 4))
    spec = ctm_mod.partition_spec(data_axis=("data", "vocab"), vocab_axis="vocab")
    step_l = ctm_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        chunk_docs=4, axis_name=("data", "vocab"), vocab_axis="vocab")
    dspec = P(("data", "vocab"))
    step = jax.jit(shard_map(
        step_l, mesh=mesh, in_specs=(spec, dspec, dspec, dspec, P()),
        out_specs=spec, check_vma=False))
    s = st
    for _ in range(2):
        s = step(s, *data)
    np.testing.assert_allclose(np.asarray(s.beta), np.asarray(ref.beta), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(s.lam), np.asarray(ref.lam), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s.sigma), np.asarray(ref.sigma), rtol=1e-7)


@pytest.mark.slow
def test_ctpf_vocab_and_user_axis_tp_matches_single_device():
    """CTPF with alef sharded over vocab and he sharded over users."""
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.models import ctpf as ctpf_mod
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus

    K = 4
    corp = tm.synth_corpus(M=32, V=256, K=3, U=16, seed=6,
                           mean_terms=10, mean_tokens=16)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=8,
                         with_readers=True)
    st = ctpf_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.readers), jnp.asarray(packed.ratings),
            jnp.asarray(packed.doc_mask))
    step1 = jax.jit(ctpf_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, chunk_docs=8, axis_name=None))
    ref = st
    for _ in range(2):
        ref = step1(ref, *data)

    # 2 data × 2 vocab × 2 user mesh; docs sharded over all three axes
    mesh = make_mesh(axis_names=("data", "vocab", "user"), shape=(2, 2, 2))
    axes = ("data", "vocab", "user")
    spec = ctpf_mod.partition_spec(data_axis=axes, vocab_axis="vocab",
                                   user_axis="user")
    step_l = ctpf_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, chunk_docs=4, axis_name=axes,
        vocab_axis="vocab", user_axis="user")
    dspec = P(axes)
    step = jax.jit(shard_map(
        step_l, mesh=mesh,
        in_specs=(spec, dspec, dspec, dspec, dspec, dspec),
        out_specs=spec, check_vma=False))
    s = st
    for _ in range(2):
        s = step(s, *data)
    for f in ("alef", "bet", "gimel", "dalet", "he", "vav", "zayin", "het"):
        np.testing.assert_allclose(
            np.asarray(getattr(s, f)), np.asarray(getattr(ref, f)),
            rtol=1e-8, err_msg=f)
    elbo1 = jax.jit(ctpf_mod.make_elbo(packed, K, chunk_docs=8))
    ref_e = elbo_value(elbo1(ref, *data))
    elbo_l = ctpf_mod.make_elbo(packed, K, chunk_docs=4, axis_name=axes,
                                vocab_axis="vocab", user_axis="user")
    elbo_fn = jax.jit(shard_map(
        elbo_l, mesh=mesh,
        in_specs=(spec, dspec, dspec, dspec, dspec, dspec),
        out_specs=P(), check_vma=False))
    np.testing.assert_allclose(elbo_value(elbo_fn(s, *data)), ref_e, rtol=1e-9)


def test_flda_vocab_axis_tp_matches_single_device():
    """fLDA with beta and kappa storage sharded over a vocab axis."""
    from topicmodelsvb_jl_tpu.models import flda as flda_mod

    K = 4
    packed = _packed(M=32, V=256, L=16, seed=7)
    st = flda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask),
            jnp.asarray(float(packed.M), jnp.float64),
            jnp.asarray(float(packed.C.sum()), jnp.float64))
    step1 = jax.jit(flda_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        chunk_docs=8, axis_name=None))
    ref = st
    for _ in range(2):
        ref = step1(ref, *data)

    mesh = make_mesh(axis_names=("data", "vocab"), shape=(2, 4))
    spec = flda_mod.partition_spec(data_axis=("data", "vocab"),
                                   vocab_axis="vocab")
    step_l = flda_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        chunk_docs=4, axis_name=("data", "vocab"),
        vocab_axis="vocab")
    dspec = P(("data", "vocab"))
    step = jax.jit(shard_map(
        step_l, mesh=mesh,
        in_specs=(spec, dspec, dspec, dspec, P(), P()),
        out_specs=spec, check_vma=False))
    s = st
    for _ in range(2):
        s = step(s, *data)
    for f in ("beta", "kappa", "alpha", "eta", "gamma", "tau"):
        np.testing.assert_allclose(
            np.asarray(getattr(s, f)), np.asarray(getattr(ref, f)),
            rtol=1e-8, err_msg=f)
    # ELBO under vocab sharding must match the single-device bound
    elbo1 = jax.jit(flda_mod.make_elbo(packed, K, chunk_docs=8))
    ref_e = elbo_value(elbo1(ref, *data[:3]))
    elbo_l = flda_mod.make_elbo(packed, K, chunk_docs=4,
                                axis_name=("data", "vocab"),
                                vocab_axis="vocab")
    elbo_fn = jax.jit(shard_map(
        elbo_l, mesh=mesh, in_specs=(spec, dspec, dspec, dspec),
        out_specs=P(), check_vma=False))
    np.testing.assert_allclose(elbo_value(elbo_fn(s, *data[:3])), ref_e, rtol=1e-9)


def test_fctm_vocab_axis_tp_matches_single_device():
    from topicmodelsvb_jl_tpu.models import fctm as fctm_mod

    K = 4
    packed = _packed(M=32, V=256, L=16, seed=8)
    st = fctm_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask),
            jnp.asarray(float(packed.M), jnp.float64))
    step1 = jax.jit(fctm_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        chunk_docs=8, axis_name=None))
    ref = st
    for _ in range(2):
        ref = step1(ref, *data)

    mesh = make_mesh(axis_names=("data", "vocab"), shape=(2, 4))
    spec = fctm_mod.partition_spec(data_axis=("data", "vocab"),
                                   vocab_axis="vocab")
    step_l = fctm_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        chunk_docs=4, axis_name=("data", "vocab"), vocab_axis="vocab")
    dspec = P(("data", "vocab"))
    step = jax.jit(shard_map(
        step_l, mesh=mesh, in_specs=(spec, dspec, dspec, dspec, P()),
        out_specs=spec, check_vma=False))
    s = st
    for _ in range(2):
        s = step(s, *data)
    for f in ("beta", "kappa", "mu", "sigma", "lam", "tau"):
        np.testing.assert_allclose(
            np.asarray(getattr(s, f)), np.asarray(getattr(ref, f)),
            rtol=1e-8, err_msg=f)
    elbo1 = jax.jit(fctm_mod.make_elbo(packed, K, chunk_docs=8))
    ref_e = elbo_value(elbo1(ref, *data[:3]))
    elbo_l = fctm_mod.make_elbo(packed, K, chunk_docs=4,
                                axis_name=("data", "vocab"),
                                vocab_axis="vocab")
    elbo_fn = jax.jit(shard_map(
        elbo_l, mesh=mesh, in_specs=(spec, dspec, dspec, dspec),
        out_specs=P(), check_vma=False))
    np.testing.assert_allclose(elbo_value(elbo_fn(s, *data[:3])), ref_e, rtol=1e-9)


@pytest.mark.slow
def test_dtm_vocab_axis_tp_matches_single_device():
    """DTM with the [T, K, V] state sharded over a vocab axis: the
    Kalman smoother runs shard-local (elementwise over V); the CG
    objective psums its scalar pieces."""
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.models import dtm as dtm_mod
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus

    K = 3
    corp = tm.synth_corpus(M=32, V=256, K=3, seed=9, n_slices=3, drift=0.2,
                           mean_terms=10, mean_tokens=16)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=8)
    stamps = np.array([d.stamp for d in corp.docs])
    sid = np.clip(np.ceil((stamps - stamps.min())).astype(np.int64), 1, 3) - 1
    slice_full = np.zeros(packed.M_pad, dtype=np.int32)
    slice_full[: packed.M] = sid
    T = 3
    st = dtm_mod.init(jax.random.PRNGKey(0), packed, K, T, jnp.float64)
    data = (jnp.asarray(slice_full), jnp.asarray(packed.terms),
            jnp.asarray(packed.counts), jnp.asarray(packed.doc_mask))
    step1 = jax.jit(dtm_mod.make_step(
        packed, K, T, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        cgiter=4, cgtol=1e-9, chunk_docs=8, axis_name=None))
    ref = st
    for _ in range(2):
        ref = step1(ref, *data)

    mesh = make_mesh(axis_names=("data", "vocab"), shape=(2, 4))
    spec = dtm_mod.partition_spec(data_axis=("data", "vocab"),
                                  vocab_axis="vocab")
    step_l = dtm_mod.make_step(
        packed, K, T, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        cgiter=4, cgtol=1e-9, chunk_docs=4, axis_name=("data", "vocab"),
        vocab_axis="vocab")
    dspec = P(("data", "vocab"))
    step = jax.jit(shard_map(
        step_l, mesh=mesh,
        in_specs=(spec, dspec, dspec, dspec, dspec),
        out_specs=spec, check_vma=False))
    s = st
    for _ in range(2):
        s = step(s, *data)
    for f in ("betahat", "mbeta", "alpha", "gamma", "lzeta"):
        np.testing.assert_allclose(
            np.asarray(getattr(s, f)), np.asarray(getattr(ref, f)),
            rtol=1e-7, atol=1e-10, err_msg=f)


def test_flda_seq_axis_sp_matches_single_device():
    """fLDA with every doc's token axis (and tau) sharded (SP analogue)."""
    from topicmodelsvb_jl_tpu.models import flda as flda_mod

    K = 4
    packed = _packed(M=32, V=256, L=16, seed=12)
    st = flda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask),
            jnp.asarray(float(packed.M), jnp.float64),
            jnp.asarray(float(packed.C.sum()), jnp.float64))
    step1 = jax.jit(flda_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        chunk_docs=8, axis_name=None))
    ref = st
    for _ in range(2):
        ref = step1(ref, *data)

    mesh = make_mesh(axis_names=("data", "seq"), shape=(2, 4))
    spec = flda_mod.partition_spec(data_axis="data", seq_axis="seq")
    step_l = flda_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        chunk_docs=16, axis_name="data", seq_axis="seq")
    tokspec, dspec = P("data", "seq"), P("data")
    step = jax.jit(shard_map(
        step_l, mesh=mesh,
        in_specs=(spec, tokspec, tokspec, dspec, P(), P()),
        out_specs=spec, check_vma=False))
    s = st
    for _ in range(2):
        s = step(s, *data)
    for f in ("beta", "kappa", "alpha", "eta", "gamma", "tau"):
        np.testing.assert_allclose(
            np.asarray(getattr(s, f)), np.asarray(getattr(ref, f)),
            rtol=1e-8, err_msg=f)
    elbo1 = jax.jit(flda_mod.make_elbo(packed, K, chunk_docs=8))
    ref_e = elbo_value(elbo1(ref, *data[:3]))
    elbo_l = flda_mod.make_elbo(packed, K, chunk_docs=16, axis_name="data",
                                seq_axis="seq")
    elbo_fn = jax.jit(shard_map(
        elbo_l, mesh=mesh, in_specs=(spec, tokspec, tokspec, dspec),
        out_specs=P(), check_vma=False))
    np.testing.assert_allclose(elbo_value(elbo_fn(s, *data[:3])), ref_e, rtol=1e-9)


def test_ctm_seq_axis_sp_matches_single_device():
    """CTM with every doc's token axis sharded: the Newton inputs
    (C, phi@counts) psum over the token shards (CTM.jl:129-165)."""
    from topicmodelsvb_jl_tpu.models import ctm as ctm_mod

    K = 4
    packed = _packed(M=32, V=256, L=16, seed=13)
    st = ctm_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask),
            jnp.asarray(float(packed.M), jnp.float64))
    step1 = jax.jit(ctm_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        chunk_docs=8, axis_name=None))
    ref = st
    for _ in range(2):
        ref = step1(ref, *data)

    mesh = make_mesh(axis_names=("data", "seq"), shape=(2, 4))
    spec = ctm_mod.partition_spec(data_axis="data")
    step_l = ctm_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        chunk_docs=16, axis_name="data", seq_axis="seq")
    tokspec, dspec = P("data", "seq"), P("data")
    step = jax.jit(shard_map(
        step_l, mesh=mesh, in_specs=(spec, tokspec, tokspec, dspec, P()),
        out_specs=spec, check_vma=False))
    s = st
    for _ in range(2):
        s = step(s, *data)
    for f in ("beta", "mu", "sigma", "lam", "vsq", "logzeta"):
        np.testing.assert_allclose(
            np.asarray(getattr(s, f)), np.asarray(getattr(ref, f)),
            rtol=1e-7, err_msg=f)
    elbo1 = jax.jit(ctm_mod.make_elbo(packed, K, chunk_docs=8))
    ref_e = elbo_value(elbo1(ref, *data[:3]))
    elbo_l = ctm_mod.make_elbo(packed, K, chunk_docs=16, axis_name="data",
                               seq_axis="seq")
    elbo_fn = jax.jit(shard_map(
        elbo_l, mesh=mesh, in_specs=(spec, tokspec, tokspec, dspec),
        out_specs=P(), check_vma=False))
    np.testing.assert_allclose(elbo_value(elbo_fn(s, *data[:3])), ref_e, rtol=1e-9)


def test_fctm_seq_axis_sp_matches_single_device():
    from topicmodelsvb_jl_tpu.models import fctm as fctm_mod

    K = 4
    packed = _packed(M=32, V=256, L=16, seed=14)
    st = fctm_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask),
            jnp.asarray(float(packed.M), jnp.float64))
    step1 = jax.jit(fctm_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        chunk_docs=8, axis_name=None))
    ref = st
    for _ in range(2):
        ref = step1(ref, *data)

    mesh = make_mesh(axis_names=("data", "seq"), shape=(2, 4))
    spec = fctm_mod.partition_spec(data_axis="data", seq_axis="seq")
    step_l = fctm_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, niter=30, ntol=1.0 / K**2,
        chunk_docs=16, axis_name="data", seq_axis="seq")
    tokspec, dspec = P("data", "seq"), P("data")
    step = jax.jit(shard_map(
        step_l, mesh=mesh, in_specs=(spec, tokspec, tokspec, dspec, P()),
        out_specs=spec, check_vma=False))
    s = st
    for _ in range(2):
        s = step(s, *data)
    for f in ("beta", "kappa", "mu", "sigma", "lam", "vsq", "tau"):
        np.testing.assert_allclose(
            np.asarray(getattr(s, f)), np.asarray(getattr(ref, f)),
            rtol=1e-7, err_msg=f)
    elbo1 = jax.jit(fctm_mod.make_elbo(packed, K, chunk_docs=8))
    ref_e = elbo_value(elbo1(ref, *data[:3]))
    elbo_l = fctm_mod.make_elbo(packed, K, chunk_docs=16, axis_name="data",
                                seq_axis="seq")
    elbo_fn = jax.jit(shard_map(
        elbo_l, mesh=mesh, in_specs=(spec, tokspec, tokspec, dspec),
        out_specs=P(), check_vma=False))
    np.testing.assert_allclose(elbo_value(elbo_fn(s, *data[:3])), ref_e, rtol=1e-9)


def test_ctpf_seq_axis_sp_matches_single_device():
    """CTPF with BOTH ragged axes — the token stream and the reader list
    (the second raggedness axis, CTPF.jl:102) — sharded over seq."""
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.models import ctpf as ctpf_mod
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus

    K = 4
    corp = tm.synth_corpus(M=32, V=256, K=3, U=16, seed=15,
                           mean_terms=10, mean_tokens=16)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=8,
                         with_readers=True)
    st = ctpf_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.readers), jnp.asarray(packed.ratings),
            jnp.asarray(packed.doc_mask))
    step1 = jax.jit(ctpf_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, chunk_docs=8, axis_name=None))
    ref = st
    for _ in range(2):
        ref = step1(ref, *data)

    mesh = make_mesh(axis_names=("data", "seq"), shape=(2, 4))
    spec = ctpf_mod.partition_spec(data_axis="data")
    step_l = ctpf_mod.make_step(
        packed, K, viter=3, vtol=1.0 / K**2, chunk_docs=16, axis_name="data",
        seq_axis="seq")
    tokspec, dspec = P("data", "seq"), P("data")
    step = jax.jit(shard_map(
        step_l, mesh=mesh,
        in_specs=(spec, tokspec, tokspec, tokspec, tokspec, dspec),
        out_specs=spec, check_vma=False))
    s = st
    for _ in range(2):
        s = step(s, *data)
    for f in ("alef", "bet", "gimel", "dalet", "he", "vav", "zayin", "het"):
        np.testing.assert_allclose(
            np.asarray(getattr(s, f)), np.asarray(getattr(ref, f)),
            rtol=1e-8, err_msg=f)
    elbo1 = jax.jit(ctpf_mod.make_elbo(packed, K, chunk_docs=8))
    ref_e = elbo_value(elbo1(ref, *data))
    elbo_l = ctpf_mod.make_elbo(packed, K, chunk_docs=16, axis_name="data",
                                seq_axis="seq")
    elbo_fn = jax.jit(shard_map(
        elbo_l, mesh=mesh,
        in_specs=(spec, tokspec, tokspec, tokspec, tokspec, dspec),
        out_specs=P(), check_vma=False))
    np.testing.assert_allclose(elbo_value(elbo_fn(s, *data)), ref_e, rtol=1e-9)


def test_lda_3d_dp_tp_sp_mesh_matches_single_device():
    """Full 3-axis combination on one mesh: docs data-parallel over
    data×vocab, beta storage tensor-parallel over vocab, every document's
    token axis sequence-parallel over seq (the dryrun's 2×2×2 config,
    asserted against the single-device trajectory)."""
    K = 6
    packed = _packed()
    ref, ref_elbo = _reference_run(packed, K)

    mesh = make_mesh(axis_names=("data", "vocab", "seq"), shape=(2, 2, 2))
    axes = ("data", "vocab")
    spec = lda_mod.partition_spec(data_axis=axes, vocab_axis="vocab")
    step_l = lda_mod.make_step(
        packed, K, viter=5, vtol=1.0 / K**2, niter=100, ntol=1.0 / K**2,
        chunk_docs=16, axis_name=axes, use_pallas=False,
        vocab_axis="vocab", seq_axis="seq")
    elbo_l = lda_mod.make_elbo(
        packed, K, chunk_docs=16, axis_name=axes, vocab_axis="vocab",
        seq_axis="seq")
    dspec = P(axes)
    tokspec = P(axes, "seq")
    step = jax.jit(shard_map(
        step_l, mesh=mesh, in_specs=(spec, tokspec, tokspec, dspec, P()),
        out_specs=spec, check_vma=False))
    elbo_fn = jax.jit(shard_map(
        elbo_l, mesh=mesh, in_specs=(spec, tokspec, tokspec, dspec),
        out_specs=P(), check_vma=False))

    state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask),
            jnp.asarray(float(packed.M), jnp.float64))
    for _ in range(3):
        state = step(state, *data)
    np.testing.assert_allclose(np.asarray(state.beta), np.asarray(ref.beta),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(state.gamma), np.asarray(ref.gamma),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(state.alpha), np.asarray(ref.alpha),
                               rtol=1e-7)
    np.testing.assert_allclose(elbo_value(elbo_fn(state, *data[:3])), ref_elbo,
                               rtol=1e-9)


@pytest.mark.slow
def test_hmtm_vocab_axis_tp_matches_single_device():
    """HMTM with beta storage sharded over a vocab axis (TP): the
    forward-backward E-step all-gathers beta once per sweep and the
    beta statistic reduce-scatters back — same trajectory + ELBO."""
    from topicmodelsvb_jl_tpu.models import hmtm as hmtm_mod

    K = 4
    packed = unit_counts(_packed(M=32, V=256, L=16))

    def run(mesh_axes, shape, vocab_axis):
        state = hmtm_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float64)
        data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
                jnp.asarray(packed.doc_mask),
                jnp.asarray(float(packed.M), jnp.float64))
        kw = dict(viter=5, vtol=1.0 / K**2, niter=100, ntol=1.0 / K**2,
                  chunk_docs=8)
        if mesh_axes is None:
            step = jax.jit(hmtm_mod.make_step(packed, K, axis_name=None, **kw))
            elbo_fn = jax.jit(hmtm_mod.make_elbo(packed, K, chunk_docs=8))
        else:
            mesh = make_mesh(axis_names=mesh_axes, shape=shape)
            spec = hmtm_mod.partition_spec(data_axis=mesh_axes,
                                           vocab_axis=vocab_axis)
            step_l = hmtm_mod.make_step(packed, K, axis_name=mesh_axes,
                                        vocab_axis=vocab_axis, **kw)
            elbo_l = hmtm_mod.make_elbo(packed, K, chunk_docs=8,
                                        axis_name=mesh_axes,
                                        vocab_axis=vocab_axis)
            dspec = P(mesh_axes)
            step = jax.jit(shard_map(
                step_l, mesh=mesh, in_specs=(spec, dspec, dspec, dspec, P()),
                out_specs=spec, check_vma=False))
            elbo_fn = jax.jit(shard_map(
                elbo_l, mesh=mesh, in_specs=(spec, dspec, dspec, dspec),
                out_specs=P(), check_vma=False))
        for _ in range(3):
            state = step(state, *data)
        return state, elbo_value(elbo_fn(state, *data[:3]))

    ref, ref_elbo = run(None, None, None)
    tp, tp_elbo = run(("data", "vocab"), (2, 4), "vocab")
    np.testing.assert_allclose(np.asarray(tp.beta), np.asarray(ref.beta),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(tp.tau), np.asarray(ref.tau),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tp.gamma), np.asarray(ref.gamma),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tp.alpha), np.asarray(ref.alpha),
                               rtol=1e-7)
    np.testing.assert_allclose(tp_elbo, ref_elbo, rtol=1e-9)
