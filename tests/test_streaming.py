"""Host-streamed training (streaming.py): trajectory equality with the
in-memory path, batch-size invariance, beyond-memory semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topicmodelsvb_jl_tpu.utils.numerics import elbo_value

from topicmodelsvb_jl_tpu.datasets import synth_packed_nsf_scale
from topicmodelsvb_jl_tpu.ops.packing import unit_counts
from topicmodelsvb_jl_tpu.models import lda as lda_mod
from topicmodelsvb_jl_tpu.streaming import StreamingLDA


def _packed(M=96, V=50, seed=4):
    return synth_packed_nsf_scale(M=M, V=V, mean_terms=10, seed=seed,
                                  chunk_docs=16, pad_multiple=8)


def _inmemory_run(packed, K, iters, viter=5):
    state = lda_mod.init(jax.random.PRNGKey(3), packed, K, jnp.float64)
    vtol = 1.0 / K**2
    step = jax.jit(lda_mod.make_step(
        packed, K, viter=viter, vtol=vtol, niter=100, ntol=vtol,
        chunk_docs=16, axis_name=None, use_pallas=False))
    elbo = jax.jit(lda_mod.make_elbo(packed, K, chunk_docs=16))
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts.astype(np.float64)),
            jnp.asarray(packed.doc_mask.astype(np.float64)),
            jnp.asarray(float(packed.M), jnp.float64))
    for _ in range(iters):
        state = step(state, *data)
    return state, elbo_value(elbo(state, *data[:3]))


def test_streaming_matches_inmemory_trajectory():
    K, iters = 3, 4
    packed = _packed()
    ref, ref_elbo = _inmemory_run(packed, K, iters)

    s = StreamingLDA(packed, K, batch_docs=32, chunk_docs=16,
                     dtype=jnp.float64, seed=3)
    s.train(iter=iters, checkelbo=float("inf"), viter=5, printelbo=False)

    np.testing.assert_allclose(np.asarray(s.beta), np.asarray(ref.beta),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(s.alpha), np.asarray(ref.alpha),
                               rtol=1e-10)
    np.testing.assert_allclose(s.gamma, np.asarray(ref.gamma), rtol=1e-10)
    # streamed ELBO equals the in-memory bound
    from topicmodelsvb_jl_tpu.streaming import make_batch_elbo

    be = make_batch_elbo(packed.V, K, 16)
    np.testing.assert_allclose(s._sweep_elbo(be, s.beta, s.beta_old),
                               ref_elbo, rtol=1e-10)


def test_streaming_batch_size_invariance():
    """beta/alpha are frozen within a sweep, so the batch partition must
    not change the result at all."""
    K, iters = 3, 3
    packed = _packed(M=96, seed=9)
    runs = []
    for batch in (96, 48, 16):
        s = StreamingLDA(packed, K, batch_docs=batch, chunk_docs=16,
                         dtype=jnp.float64, seed=3)
        s.train(iter=iters, checkelbo=1, printelbo=False, viter=5, tol=0.0)
        runs.append(s)
    for s in runs[1:]:
        np.testing.assert_allclose(np.asarray(s.beta),
                                   np.asarray(runs[0].beta), rtol=1e-12)
        np.testing.assert_allclose([t[1] for t in s.trace],
                                   [t[1] for t in runs[0].trace], rtol=1e-12)


def test_streaming_elbo_monotone_and_topics():
    packed = _packed(M=64, seed=2)
    s = StreamingLDA(packed, 4, batch_docs=32, chunk_docs=16,
                     dtype=jnp.float64, seed=1)
    s.train(iter=8, checkelbo=1, printelbo=False, tol=0.0)
    deltas = [t[2] for t in s.trace]
    assert all(d > -1e-6 for d in deltas[1:])
    assert s.topics is not None and s.topics.shape == (4, packed.V)


def test_online_training_beats_one_batch_sweep():
    """One ONLINE epoch (beta updated per minibatch) must reach a better
    bound than one BATCH sweep (beta updated once) — the point of
    stochastic variational inference on large corpora."""
    from topicmodelsvb_jl_tpu.streaming import make_batch_elbo

    K = 4
    packed = synth_packed_nsf_scale(M=1024, V=80, mean_terms=12, seed=6,
                                    chunk_docs=16, pad_multiple=8)

    batch = StreamingLDA(packed, K, batch_docs=64, chunk_docs=16,
                         dtype=jnp.float64, seed=3)
    batch.train(iter=1, checkelbo=1, printelbo=False, tol=0.0)
    elbo_batch = batch.trace[-1][1]

    online = StreamingLDA(packed, K, batch_docs=64, chunk_docs=16,
                          dtype=jnp.float64, seed=3)
    # tau0 sized to the step count (16/epoch) so the schedule actually
    # learns within one pass
    online.train_online(epochs=1, tau0=4.0, checkelbo=1, printelbo=False)
    elbo_online = online.trace[-1][1]

    assert np.isfinite(elbo_online)
    assert elbo_online > elbo_batch, (elbo_online, elbo_batch)
    assert online.topics is not None


def test_online_training_elbo_climbs_across_epochs():
    K = 3
    packed = synth_packed_nsf_scale(M=256, V=60, mean_terms=10, seed=7,
                                    chunk_docs=16, pad_multiple=8)
    s = StreamingLDA(packed, K, batch_docs=64, chunk_docs=16,
                     dtype=jnp.float64, seed=2)
    s.train_online(epochs=4, checkelbo=1, printelbo=False)
    elbos = [t[1] for t in s.trace]
    assert elbos[-1] > elbos[0]
    with pytest.raises(ValueError):
        s.train_online(epochs=1, kappa=0.3)



@pytest.mark.slow
def test_streaming_over_mesh_matches_single_device():
    """Streaming + DP: each batch shards over a 4-device mesh, stats
    psum across devices — trajectory identical to single-device
    streaming and to the in-memory path."""
    from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh

    K, iters = 3, 3
    packed = _packed(M=96, seed=4)
    ref, _ = _inmemory_run(packed, K, iters)

    s = StreamingLDA(packed, K, batch_docs=32, chunk_docs=8,
                     dtype=jnp.float64, seed=3,
                     mesh=make_mesh(n_devices=4, axis_names=("data",)))
    s.train(iter=iters, checkelbo=float("inf"), viter=5, printelbo=False)
    np.testing.assert_allclose(np.asarray(s.beta), np.asarray(ref.beta),
                               rtol=1e-12)
    np.testing.assert_allclose(s.gamma, np.asarray(ref.gamma), rtol=1e-10)

    o = StreamingLDA(packed, K, batch_docs=32, chunk_docs=8,
                     dtype=jnp.float64, seed=3,
                     mesh=make_mesh(n_devices=4, axis_names=("data",)))
    o.train_online(epochs=2, tau0=4.0, checkelbo=1, printelbo=False)
    o1 = StreamingLDA(packed, K, batch_docs=32, chunk_docs=8,
                      dtype=jnp.float64, seed=3)
    o1.train_online(epochs=2, tau0=4.0, checkelbo=1, printelbo=False)
    np.testing.assert_allclose(np.asarray(o.beta), np.asarray(o1.beta),
                               rtol=1e-11)


# ─────────────────────────── StreamingCTPF ───────────────────────────

def _packed_readers(M=96, V=50, U=20, seed=4, docs_multiple=32):
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus

    corp = tm.synth_corpus(M=M, V=V, U=U, K=3, seed=seed, mean_terms=10,
                           mean_readers=3)
    return pack_corpus(corp, pad_multiple=8, docs_multiple=docs_multiple,
                       with_readers=True, dtype=np.float64)


def _inmemory_ctpf(packed, K, iters, viter=5):
    from topicmodelsvb_jl_tpu.models import ctpf as ctpf_mod

    state = ctpf_mod.init(jax.random.PRNGKey(3), packed, K, jnp.float64)
    vtol = 1.0 / K**2
    step = jax.jit(ctpf_mod.make_step(
        packed, K, viter=viter, vtol=vtol, chunk_docs=16, axis_name=None))
    elbo = jax.jit(ctpf_mod.make_elbo(packed, K, chunk_docs=16))
    data = (jnp.asarray(packed.terms),
            jnp.asarray(packed.counts.astype(np.float64)),
            jnp.asarray(packed.readers),
            jnp.asarray(packed.ratings.astype(np.float64)),
            jnp.asarray(packed.doc_mask.astype(np.float64)))
    for _ in range(iters):
        state = step(state, *data)
    return state, elbo_value(elbo(state, *data))


def test_streaming_ctpf_matches_inmemory_trajectory():
    from topicmodelsvb_jl_tpu.streaming import StreamingCTPF

    K, iters = 3, 4
    packed = _packed_readers()
    ref, ref_elbo = _inmemory_ctpf(packed, K, iters)

    s = StreamingCTPF(packed, K, batch_docs=32, chunk_docs=16,
                      dtype=jnp.float64, seed=3)
    s.train(iter=iters, checkelbo=float("inf"), viter=5, printelbo=False)

    for name in ("alef", "bet", "dalet", "he", "vav", "het"):
        np.testing.assert_allclose(np.asarray(getattr(s, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(s.gimel, np.asarray(ref.gimel), rtol=1e-10)
    np.testing.assert_allclose(s.zayin, np.asarray(ref.zayin), rtol=1e-10)
    # streamed ELBO equals the in-memory bound
    np.testing.assert_allclose(s._sweep_elbo(), ref_elbo, rtol=1e-10)


@pytest.mark.slow
def test_streaming_ctpf_batch_partition_invariance():
    from topicmodelsvb_jl_tpu.streaming import StreamingCTPF

    K, iters = 3, 3
    packed = _packed_readers(seed=9)
    runs = []
    for batch in (96, 48, 16):
        s = StreamingCTPF(packed, K, batch_docs=batch, chunk_docs=16,
                          dtype=jnp.float64, seed=3)
        s.train(iter=iters, checkelbo=1, printelbo=False, viter=5, tol=0.0)
        runs.append(s)
    for s in runs[1:]:
        np.testing.assert_allclose(np.asarray(s.alef),
                                   np.asarray(runs[0].alef), rtol=1e-12)
        np.testing.assert_allclose([t[1] for t in s.trace],
                                   [t[1] for t in runs[0].trace],
                                   rtol=1e-12)


@pytest.mark.slow
def test_streaming_ctpf_over_mesh_matches_single_device():
    from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
    from topicmodelsvb_jl_tpu.streaming import StreamingCTPF

    K, iters = 3, 3
    packed = _packed_readers(seed=5)
    ref, ref_elbo = _inmemory_ctpf(packed, K, iters, viter=5)

    s = StreamingCTPF(packed, K, batch_docs=32, chunk_docs=8,
                      dtype=jnp.float64, seed=3,
                      mesh=make_mesh(n_devices=4, axis_names=("data",)))
    s.train(iter=iters, checkelbo=float("inf"), viter=5, printelbo=False)
    np.testing.assert_allclose(np.asarray(s.alef), np.asarray(ref.alef),
                               rtol=1e-12)
    np.testing.assert_allclose(s.gimel, np.asarray(ref.gimel), rtol=1e-10)
    np.testing.assert_allclose(s._sweep_elbo(), ref_elbo, rtol=1e-10)


@pytest.mark.slow
def test_streaming_ctpf_online_climbs_and_scores():
    from topicmodelsvb_jl_tpu.streaming import StreamingCTPF

    K = 3
    packed = _packed_readers(M=256, seed=7, docs_multiple=64)
    s = StreamingCTPF(packed, K, batch_docs=64, chunk_docs=16,
                      dtype=jnp.float64, seed=2)
    s.train_online(epochs=4, tau0=4.0, checkelbo=1, printelbo=False)
    elbos = [t[1] for t in s.trace]
    assert elbos[-1] > elbos[0]
    assert s.topics is not None and s.topics.shape == (K, packed.V)
    sc = s.scores()
    assert sc.shape == (s.M, s.U) and np.all(sc >= 0)
    with pytest.raises(ValueError):
        s.train_online(epochs=1, kappa=0.3)


# ───────────────── streaming checkpoint/resume ─────────────────

def test_streaming_lda_checkpoint_resume(tmp_path):
    from topicmodelsvb_jl_tpu import streaming as st

    K, total, k_cut = 3, 6, 3
    packed = _packed(M=96, seed=8)
    ref = st.StreamingLDA(packed, K, batch_docs=32, chunk_docs=16,
                          dtype=jnp.float64, seed=3)
    ref.train(iter=total, checkelbo=1, tol=0.0, printelbo=False)

    s = st.StreamingLDA(packed, K, batch_docs=32, chunk_docs=16,
                        dtype=jnp.float64, seed=3)
    s.train(iter=k_cut, checkelbo=1, tol=0.0, printelbo=False)
    path = str(tmp_path / "stream.ckpt")
    s.save(path)

    r = st.load(path, packed)
    assert isinstance(r, st.StreamingLDA)
    r.train(iter=total - k_cut, checkelbo=1, tol=0.0, printelbo=False)
    np.testing.assert_allclose(np.asarray(r.beta), np.asarray(ref.beta),
                               rtol=1e-12)
    np.testing.assert_allclose([t[1] for t in r.trace],
                               [t[1] for t in ref.trace], rtol=1e-12)
    # the resumed run CONTINUES k (4,5,6) — trace rows stay unique and
    # ckpt_iterNNNNNN names can never reuse a pre-resume number
    assert [t[0] for t in r.trace] == [t[0] for t in ref.trace]
    assert r.trained_iters == ref.trained_iters == total
    # fingerprint guard
    other = _packed(M=96, seed=12345)
    with pytest.raises(ValueError):
        st.load(path, other)


def test_streaming_dir_checkpoint_shard_validation(tmp_path):
    """A directory checkpoint whose proc*.npz set disagrees with the
    manifest's nproc must be rejected loudly — a missing shard would
    silently leave its rows at init values, an extra (stale) shard
    would scatter a dead run's rows over fresh data."""
    import json

    from topicmodelsvb_jl_tpu import streaming as st

    packed = _packed(M=96, seed=8)
    d = tmp_path / "dir.ckpt"
    d.mkdir()
    (d / "manifest.json").write_text(
        json.dumps(dict(format=2, nproc=2, cls="StreamingLDA")))
    (d / "proc0.npz").write_bytes(b"")           # proc1.npz missing
    with pytest.raises(ValueError, match="shard mismatch"):
        st.load(str(d), packed)
    (d / "proc1.npz").write_bytes(b"")
    (d / "proc2.npz").write_bytes(b"")           # stale extra shard
    with pytest.raises(ValueError, match="shard mismatch"):
        st.load(str(d), packed)


@pytest.mark.slow
def test_streaming_ctpf_checkpoint_resume(tmp_path):
    from topicmodelsvb_jl_tpu import streaming as st

    K, total, k_cut = 3, 5, 2
    packed = _packed_readers(seed=6)
    ref = st.StreamingCTPF(packed, K, batch_docs=32, chunk_docs=16,
                           dtype=jnp.float64, seed=3)
    ref.train(iter=total, checkelbo=1, tol=0.0, printelbo=False)

    s = st.StreamingCTPF(packed, K, batch_docs=32, chunk_docs=16,
                         dtype=jnp.float64, seed=3)
    s.train(iter=k_cut, checkelbo=1, tol=0.0, printelbo=False)
    path = str(tmp_path / "stream_ctpf.ckpt")
    s.save(path)

    r = st.load(path, packed)
    assert isinstance(r, st.StreamingCTPF)
    r.train(iter=total - k_cut, checkelbo=1, tol=0.0, printelbo=False)
    np.testing.assert_allclose(np.asarray(r.alef), np.asarray(ref.alef),
                               rtol=1e-12)
    np.testing.assert_allclose([t[1] for t in r.trace],
                               [t[1] for t in ref.trace], rtol=1e-12)


def test_streaming_online_checkpoint_resume(tmp_path):
    """Online resume must replay the shuffle schedule AND the running
    SVI statistics: the resumed trajectory equals the uninterrupted
    one exactly."""
    from topicmodelsvb_jl_tpu import streaming as st

    K = 3
    packed = _packed(M=96, seed=10)
    ref = st.StreamingLDA(packed, K, batch_docs=32, chunk_docs=16,
                          dtype=jnp.float64, seed=3)
    ref.train_online(epochs=4, tau0=4.0, checkelbo=1, printelbo=False)

    s = st.StreamingLDA(packed, K, batch_docs=32, chunk_docs=16,
                        dtype=jnp.float64, seed=3)
    s.train_online(epochs=2, tau0=4.0, checkelbo=1, printelbo=False)
    path = str(tmp_path / "stream_online.ckpt")
    s.save(path)

    r = st.load(path, packed)
    assert r._svi_t == s._svi_t and r._epochs_done == 2
    r.train_online(epochs=2, tau0=4.0, checkelbo=1, printelbo=False)
    np.testing.assert_allclose(np.asarray(r.beta), np.asarray(ref.beta),
                               rtol=1e-12)
    np.testing.assert_allclose([t[1] for t in r.trace],
                               [t[1] for t in ref.trace], rtol=1e-12)


# ─────────────── StreamingCTM / StreamingFLDA / StreamingFCTM ───────────────

def _inmemory_generic(name, packed, K, iters, viter=4):
    """Run the in-memory model step for trajectory comparison."""
    vtol = 1.0 / K**2
    key = jax.random.PRNGKey(3)
    dm = jnp.asarray(packed.doc_mask.astype(np.float64))
    base = (jnp.asarray(packed.terms),
            jnp.asarray(packed.counts.astype(np.float64)), dm)
    M_total = jnp.asarray(float(packed.M), jnp.float64)
    if name == "ctm":
        from topicmodelsvb_jl_tpu.models import ctm as mod
        step = jax.jit(mod.make_step(
            packed, K, viter=viter, vtol=vtol, niter=50, ntol=vtol,
            chunk_docs=16, axis_name=None))
        data = base + (M_total,)
    elif name == "flda":
        from topicmodelsvb_jl_tpu.models import flda as mod
        step = jax.jit(mod.make_step(
            packed, K, viter=viter, vtol=vtol, niter=50, ntol=vtol,
            chunk_docs=16, axis_name=None))
        C_total = jnp.asarray(float(packed.C.sum()), jnp.float64)
        data = base + (M_total, C_total)
    elif name == "hmtm":
        from topicmodelsvb_jl_tpu.models import hmtm as mod
        step = jax.jit(mod.make_step(
            packed, K, viter=viter, vtol=vtol, niter=50, ntol=vtol,
            chunk_docs=16, axis_name=None))
        data = base + (M_total,)
    elif name == "dtm":
        from topicmodelsvb_jl_tpu.models import dtm as mod
        T = 3
        sid = jnp.asarray(_dtm_slices(packed, T))
        step = jax.jit(mod.make_step(
            packed, K, T, viter=viter, vtol=vtol, niter=50, ntol=vtol,
            cgiter=5, cgtol=1.0 / T**2, chunk_docs=16, axis_name=None))
        elbo = jax.jit(mod.make_elbo(packed, K, T, chunk_docs=16))
        state = mod.init(key, packed, K, T, jnp.float64)
        data = (sid,) + base
        for _ in range(iters):
            state = step(state, *data)
        return state, elbo_value(elbo(state, *data))
    else:
        from topicmodelsvb_jl_tpu.models import fctm as mod
        step = jax.jit(mod.make_step(
            packed, K, viter=viter, vtol=vtol, niter=50, ntol=vtol,
            chunk_docs=16, axis_name=None))
        data = base + (M_total,)
    elbo = jax.jit(mod.make_elbo(packed, K, chunk_docs=16))
    state = mod.init(key, packed, K, jnp.float64)
    for _ in range(iters):
        state = step(state, *data)
    return state, elbo_value(elbo(state, *base))


def _dtm_slices(packed, T=3):
    """Deterministic synthetic slice assignment for the DTM cases."""
    sid = (np.arange(packed.M_pad) % T).astype(np.int32)
    return sid


def _stream_extra(name, packed):
    """Extra ctor/train kwargs for families whose signatures differ."""
    if name == "dtm":
        return (dict(T=3, slice_id=_dtm_slices(packed, 3)),
                dict(cgiter=5))
    return {}, {}


_STREAM_CASES = {
    "ctm": ("StreamingCTM",
            ("mu", "sigma", "invsigma", "beta"),
            ("lam", "vsq", "logzeta")),
    "flda": ("StreamingFLDA",
             ("eta", "alpha", "kappa", "beta"),
             ("gamma", "Elogtheta", "tau")),
    "fctm": ("StreamingFCTM",
             ("eta", "mu", "sigma", "kappa", "beta"),
             ("lam", "vsq", "logzeta", "tau")),
    "hmtm": ("StreamingHMTM",
             ("eta", "alpha", "beta"),
             ("tau", "gamma")),
    "dtm": ("StreamingDTM",
            ("alpha", "betahat", "mbeta"),
            ("gamma", "Elogtheta", "lzeta")),
}


@pytest.mark.parametrize("name", list(_STREAM_CASES))
def test_streaming_generic_matches_inmemory(name):
    """CTM/fLDA/fCTM host-streamed training reproduces the in-memory
    trajectory exactly (globals frozen within a sweep), including the
    streamed ELBO."""
    from topicmodelsvb_jl_tpu import streaming as st

    K, iters, viter = 3, 3, 4
    packed = _packed(M=64, V=40, seed=5)
    if name == "hmtm":   # HMTM requires an order-preserving corpus
        packed = unit_counts(packed)
    ref, ref_elbo = _inmemory_generic(name, packed, K, iters, viter=viter)

    cls_name, globals_, docs_ = _STREAM_CASES[name]
    ctor_x, train_x = _stream_extra(name, packed)
    s = getattr(st, cls_name)(packed, K, batch_docs=32, chunk_docs=16,
                              dtype=jnp.float64, seed=3, **ctor_x)
    s.train(iter=iters, checkelbo=float("inf"), viter=viter,
            niter=50, printelbo=False, **train_x)

    for g in globals_:
        np.testing.assert_allclose(np.asarray(getattr(s, g)),
                                   np.asarray(getattr(ref, g)),
                                   rtol=1e-10, err_msg=g)
    for d in docs_:
        np.testing.assert_allclose(np.asarray(getattr(s, d)),
                                   np.asarray(getattr(ref, d)),
                                   rtol=1e-9, atol=1e-12, err_msg=d)
    np.testing.assert_allclose(s._sweep_elbo(), ref_elbo, rtol=1e-10)


@pytest.mark.parametrize("name", list(_STREAM_CASES))
@pytest.mark.slow
def test_streaming_generic_batch_partition_invariance(name):
    from topicmodelsvb_jl_tpu import streaming as st

    K = 3
    packed = _packed(M=64, V=40, seed=8)
    if name == "hmtm":   # HMTM requires an order-preserving corpus
        packed = unit_counts(packed)
    cls = getattr(st, _STREAM_CASES[name][0])
    ctor_x, train_x = _stream_extra(name, packed)
    gname = _STREAM_CASES[name][1][-1]
    runs = []
    for batch in (64, 16):
        s = cls(packed, K, batch_docs=batch, chunk_docs=16,
                dtype=jnp.float64, seed=3, **ctor_x)
        s.train(iter=2, checkelbo=1, tol=0.0, viter=4, printelbo=False,
                **train_x)
        runs.append(s)
    np.testing.assert_allclose(np.asarray(getattr(runs[0], gname)),
                               np.asarray(getattr(runs[1], gname)),
                               rtol=1e-12)
    np.testing.assert_allclose([t[1] for t in runs[0].trace],
                               [t[1] for t in runs[1].trace], rtol=1e-12)


@pytest.mark.parametrize("name", list(_STREAM_CASES))
@pytest.mark.slow
def test_streaming_generic_checkpoint_and_online(name):
    """Checkpoint/resume continues the exact batch trajectory; one
    online epoch produces a finite climbing bound and topics."""
    import tempfile

    from topicmodelsvb_jl_tpu import streaming as st

    K = 3
    packed = _packed(M=64, V=40, seed=11)
    if name == "hmtm":   # HMTM requires an order-preserving corpus
        packed = unit_counts(packed)
    cls = getattr(st, _STREAM_CASES[name][0])
    ctor_x, train_x = _stream_extra(name, packed)
    # the word-distribution global whose restore certifies the resume
    gname = _STREAM_CASES[name][1][-1]

    ref = cls(packed, K, batch_docs=32, chunk_docs=16,
              dtype=jnp.float64, seed=3, **ctor_x)
    ref.train(iter=4, checkelbo=1, tol=0.0, viter=4, printelbo=False,
              **train_x)

    s = cls(packed, K, batch_docs=32, chunk_docs=16,
            dtype=jnp.float64, seed=3, **ctor_x)
    s.train(iter=2, checkelbo=1, tol=0.0, viter=4, printelbo=False,
            **train_x)
    with tempfile.TemporaryDirectory() as td:
        path = td + "/stream.ckpt"
        s.save(path)
        r = st.load(path, packed)
    r.train(iter=2, checkelbo=1, tol=0.0, viter=4, printelbo=False,
            **train_x)
    np.testing.assert_allclose(np.asarray(getattr(r, gname)),
                               np.asarray(getattr(ref, gname)), rtol=1e-12)
    np.testing.assert_allclose([t[1] for t in r.trace],
                               [t[1] for t in ref.trace], rtol=1e-10)

    o = cls(packed, K, batch_docs=16, chunk_docs=16,
            dtype=jnp.float64, seed=3, **ctor_x)
    o.train_online(epochs=2, tau0=4.0, checkelbo=1, printelbo=False,
                   **train_x)
    elbos = [t[1] for t in o.trace]
    assert np.isfinite(elbos).all() and elbos[-1] >= elbos[0] - 1e-6
    expect_shape = ((3, K, packed.V) if name == "dtm"
                    else (K, packed.V))
    assert o.topics is not None and o.topics.shape == expect_shape


@pytest.mark.slow
def test_streaming_to_model_bridge():
    """to_model() materialises the streamed state as the api model:
    identical parameters (through the bucketed row permutation) and the
    full post-hoc surface working on them."""
    from topicmodelsvb_jl_tpu import streaming as st

    K = 3
    packed = _packed(M=64, V=40, seed=13)
    s = st.StreamingLDA(packed, K, batch_docs=32, chunk_docs=16,
                        dtype=jnp.float64, seed=3)
    s.train(iter=3, checkelbo=1, tol=0.0, viter=4, printelbo=False)
    m = s.to_model()
    np.testing.assert_allclose(np.asarray(m.state.beta),
                               np.asarray(s.beta), rtol=0)
    np.testing.assert_allclose(
        np.asarray(m.state.gamma)[m._doc_rows()], s.gamma[: s.M], rtol=0)
    assert m.topics is not None
    np.testing.assert_array_equal(m.topics, s.topics)
    td = m.topicdist(1)
    np.testing.assert_allclose(np.sum(td), 1.0, rtol=1e-6)
    assert float(m.elbo) == s.elbo

    # per-token state (tau) rides the bridge too
    f = st.StreamingFLDA(packed, K, batch_docs=32, chunk_docs=16,
                         dtype=jnp.float64, seed=3)
    f.train(iter=2, checkelbo=float("inf"), viter=3, printelbo=False)
    mf = f.to_model()
    np.testing.assert_allclose(np.asarray(mf.state.kappa),
                               np.asarray(f.kappa), rtol=0)
    L_b = np.asarray(mf.state.tau).shape[1]
    np.testing.assert_allclose(
        np.asarray(mf.state.tau)[mf._doc_rows()], f.tau[: f.M, :L_b],
        rtol=0)

    # CTPF: recommender surface (drecs/urecs) on streamed parameters
    packed_r = _packed_readers(M=64, V=40, U=12, seed=13)
    c = st.StreamingCTPF(packed_r, K, batch_docs=32, chunk_docs=16,
                         dtype=jnp.float64, seed=3)
    c.train(iter=3, checkelbo=float("inf"), viter=4, printelbo=False)
    mc = c.to_model()
    np.testing.assert_allclose(np.asarray(mc.state.alef),
                               np.asarray(c.alef), rtol=0)
    recs = mc.drecs[0]
    assert len(recs) > 0


@pytest.mark.slow
def test_streaming_generic_over_mesh_matches_single_device():
    """The generic batch sweep's shard_map path (StreamingCTM here,
    representative of CTM/fLDA/fCTM): stats psum across a 4-device
    mesh, trajectory identical to single-device streaming."""
    from topicmodelsvb_jl_tpu import streaming as st
    from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh

    K = 3
    packed = _packed(M=64, V=40, seed=14)
    ref = st.StreamingCTM(packed, K, batch_docs=32, chunk_docs=8,
                          dtype=jnp.float64, seed=3)
    ref.train(iter=3, checkelbo=1, tol=0.0, viter=4, printelbo=False)

    s = st.StreamingCTM(packed, K, batch_docs=32, chunk_docs=8,
                        dtype=jnp.float64, seed=3,
                        mesh=make_mesh(n_devices=4, axis_names=("data",)))
    s.train(iter=3, checkelbo=1, tol=0.0, viter=4, printelbo=False)
    np.testing.assert_allclose(np.asarray(s.beta), np.asarray(ref.beta),
                               rtol=1e-11)
    np.testing.assert_allclose(np.asarray(s.mu), np.asarray(ref.mu),
                               rtol=1e-10)
    np.testing.assert_allclose(s.lam, ref.lam, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose([t[1] for t in s.trace],
                               [t[1] for t in ref.trace], rtol=1e-10)


@pytest.mark.slow
def test_streaming_lda_tp_vocab_axis_matches_single_device():
    """Streaming × TP composition: beta storage shards over a 2-D
    data×vocab mesh while batches stream — trajectory identical to
    single-device streaming."""
    from topicmodelsvb_jl_tpu import streaming as st
    from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh

    K = 3
    packed = _packed(M=64, V=50, seed=15)
    ref = st.StreamingLDA(packed, K, batch_docs=32, chunk_docs=8,
                          dtype=jnp.float64, seed=3)
    ref.train(iter=3, checkelbo=1, tol=0.0, viter=4, printelbo=False)

    mesh = make_mesh(n_devices=4, axis_names=("data", "vocab"),
                     shape=(2, 2))
    s = st.StreamingLDA(packed, K, batch_docs=32, chunk_docs=8,
                        dtype=jnp.float64, seed=3, mesh=mesh,
                        vocab_axis="vocab")
    s.train(iter=3, checkelbo=1, tol=0.0, viter=4, printelbo=False)
    np.testing.assert_allclose(np.asarray(s.beta), np.asarray(ref.beta),
                               rtol=1e-11)
    np.testing.assert_allclose(np.asarray(s.alpha), np.asarray(ref.alpha),
                               rtol=1e-10)
    np.testing.assert_allclose(s.gamma, ref.gamma, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose([t[1] for t in s.trace],
                               [t[1] for t in ref.trace], rtol=1e-10)

    with pytest.raises(ValueError):
        st.StreamingLDA(packed, K, vocab_axis="vocab")   # no mesh


def test_disk_backed_streaming_matches_ram(tmp_path):
    """Full beyond-memory story (reference todo.txt:6 'stream docs from
    disk'): corpus as read-only .npy memmaps + per-doc state as writable
    memmaps must reproduce the in-RAM streamed trajectory exactly."""
    from topicmodelsvb_jl_tpu.ops.packing import load_packed, save_packed

    K, iters = 3, 3
    packed = _packed()
    save_packed(str(tmp_path / "corp"), packed)
    disk = load_packed(str(tmp_path / "corp"), mmap=True)
    assert isinstance(disk.terms, np.memmap) and isinstance(disk.C, np.memmap)
    assert not disk.terms.flags.writeable
    np.testing.assert_array_equal(np.asarray(disk.terms), packed.terms)
    assert (disk.M, disk.V, disk.L, disk.M_pad) == \
        (packed.M, packed.V, packed.L, packed.M_pad)

    ram = StreamingLDA(packed, K, batch_docs=32, chunk_docs=16,
                       dtype=jnp.float64, seed=3)
    ram.train(iter=iters, checkelbo=1, viter=5, printelbo=False)

    sd = str(tmp_path / "state")
    dm = StreamingLDA(disk, K, batch_docs=32, chunk_docs=16,
                      dtype=jnp.float64, seed=3, state_dir=sd)
    assert isinstance(dm.gamma, np.memmap)    # state genuinely on disk
    dm.train(iter=iters, checkelbo=1, viter=5, printelbo=False)

    np.testing.assert_allclose(np.asarray(dm.beta), np.asarray(ram.beta),
                               rtol=1e-14)
    np.testing.assert_allclose(dm.gamma, ram.gamma, rtol=1e-14)
    assert dm.trace == ram.trace
    # the state files are real and row-for-row identical to the RAM run
    reload = np.load(sd + "/gamma.npy", mmap_mode="r")
    np.testing.assert_allclose(np.asarray(reload), ram.gamma, rtol=1e-14)


def test_save_packed_roundtrip_readers(tmp_path):
    """Reader/rating arrays survive the save/load roundtrip (CTPF)."""
    from topicmodelsvb_jl_tpu.ops.packing import load_packed, save_packed

    packed = _packed_readers()
    save_packed(str(tmp_path / "c"), packed)
    back = load_packed(str(tmp_path / "c"), mmap=False)
    for f in ("terms", "counts", "doc_mask", "readers", "ratings", "R"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(packed, f)))
    assert (back.U, back.Rmax, back.max_rating) == \
        (packed.U, packed.Rmax, packed.max_rating)
    assert back.counts.dtype == packed.counts.dtype
