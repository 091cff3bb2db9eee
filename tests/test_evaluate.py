"""Evaluation metrics (evaluate.py): perplexity + UMass coherence."""

import numpy as np
import pytest

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.api import CTM, CTPF, LDA, fLDA
from topicmodelsvb_jl_tpu.evaluate import perplexity, topic_coherence
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig


def _rt():
    return RuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8)


@pytest.fixture(scope="module")
def split():
    corp = tm.synth_corpus(M=120, V=60, K=3, seed=8, mean_tokens=40,
                           mean_terms=20)
    train = tm.Corpus(docs=corp.docs[:100], vocab=corp.vocab)
    test = tm.Corpus(docs=corp.docs[100:], vocab=corp.vocab)
    return train, test


@pytest.mark.slow
def test_perplexity_improves_with_training(split):
    train, test = split
    m0 = LDA(train, 3, runtime=_rt(), mesh=make_mesh(n_devices=1), seed=1)
    m0.train(iter=1, checkelbo=np.inf, printelbo=False)
    p0 = perplexity(test, m0)
    m1 = LDA(train, 3, runtime=_rt(), mesh=make_mesh(n_devices=1), seed=1)
    m1.train(iter=25, checkelbo=np.inf, printelbo=False, tol=0.0)
    p1 = perplexity(test, m1)
    # trained model must beat the near-untrained one, and both must beat
    # the uniform-distribution ceiling (V=60)
    assert p1 < p0 < 60.0
    assert p1 > 1.0


@pytest.mark.slow
def test_perplexity_flda_ctm(split):
    train, test = split
    for cls in (fLDA, CTM):
        m = cls(train, 3, runtime=_rt(), mesh=make_mesh(n_devices=1), seed=1)
        m.train(iter=10, checkelbo=np.inf, printelbo=False, tol=0.0)
        p = perplexity(test, m)
        assert 1.0 < p < 60.0, (cls.__name__, p)


def test_perplexity_rejects_ctpf():
    corp = tm.synth_corpus(M=20, V=30, K=2, U=6, seed=3)
    m = CTPF(corp, 2, runtime=_rt(), mesh=make_mesh(n_devices=1))
    with pytest.raises(TypeError):
        perplexity(corp, m)


def test_topic_coherence_prefers_planted_topics():
    """Planted-topic top words co-occur; shuffled word sets do not —
    coherence must rank the trained model's topics above a fake ranking."""
    corp = tm.synth_corpus(M=200, V=60, K=3, seed=12, mean_tokens=40,
                           mean_terms=18, topic_concentration=0.05)
    m = LDA(corp, 3, runtime=_rt(), mesh=make_mesh(n_devices=1), seed=2)
    m.train(iter=30, checkelbo=np.inf, printelbo=False, tol=0.0)
    real = topic_coherence(m, N=8)
    assert real.shape == (3,) and np.all(np.isfinite(real))

    rng = np.random.default_rng(0)
    fake_topics = np.stack([rng.permutation(60) + 1 for _ in range(3)])
    saved = m.topics
    m.topics = fake_topics
    fake = topic_coherence(m, N=8)
    m.topics = saved
    assert real.mean() > fake.mean()


def test_perplexity_matches_per_doc_loop(split):
    """The vectorized packed-array scorer must equal the straightforward
    per-document loop exactly."""
    from topicmodelsvb_jl_tpu.api import predict

    train, test = split
    m = LDA(train, 3, runtime=_rt(), mesh=make_mesh(n_devices=1), seed=1)
    m.train(iter=8, checkelbo=np.inf, printelbo=False, tol=0.0)
    p_vec = perplexity(test, m)

    pred = predict(test, m, iter=10)
    beta = np.asarray(m.beta, np.float64)
    theta = np.asarray(pred._topicdist_rows(pred._doc_rows()), np.float64)
    ll, n = 0.0, 0.0
    for d, doc in enumerate(test.docs):
        if not doc.terms:
            continue
        t = np.asarray(doc.terms, np.int64) - 1
        c = np.asarray(doc.counts, np.float64)
        mix = np.maximum(theta[d] @ beta[:, t], 1e-300)
        ll += float(np.dot(c, np.log(mix)))
        n += float(c.sum())
    p_loop = float(np.exp(-ll / n))
    np.testing.assert_allclose(p_vec, p_loop, rtol=1e-12)


def test_perplexity_hmtm_is_order_aware():
    """HMTM perplexity scores documents through the HMM forward
    algorithm, so it must prefer held-out documents whose token ORDER
    matches the sticky chains it was trained on over the same
    bags-of-words with tokens shuffled."""
    from test_hmtm import _sticky_corpus

    rng = np.random.default_rng(3)
    corp, _ = _sticky_corpus(M=60, K=2, V=30, N=60, stay=0.95, seed=2)
    train = tm.Corpus(docs=corp.docs[:40], vocab=dict(corp.vocab))
    test = tm.Corpus(docs=corp.docs[40:], vocab=dict(corp.vocab))
    shuffled = tm.Corpus(
        docs=[tm.Document(terms=rng.permutation(d.terms).tolist(),
                          counts=list(d.counts)) for d in test.docs],
        vocab=dict(corp.vocab))

    # seed 0: round 5's exponential-construction init draw sent seed 1
    # to a merged-topic optimum (ordered≈shuffled); seeds 0/2/3/4 all
    # learn the chains (ratio ~0.5, scanned)
    model = tm.HMTM(train, 2, runtime=_rt(), seed=0)
    model.train(iter=20, checkelbo=5, printelbo=False)

    ppl_ordered = perplexity(test, model)
    ppl_shuffled = perplexity(shuffled, model)
    assert np.isfinite(ppl_ordered) and np.isfinite(ppl_shuffled)
    # the sticky structure is strong (95% self-transition): order
    # destruction must cost real likelihood
    assert ppl_ordered < 0.9 * ppl_shuffled


def test_holdout_readers_keeps_reader_rating_alignment():
    """Popping reader i must pop rating i — not the last rating
    (regression: a doc with readers=[5,9], ratings=[1,3] held out at
    i=0 used to leave reader 9 carrying rating 1)."""
    from topicmodelsvb_jl_tpu import Corpus, Document, holdout_readers

    docs = []
    for d in range(40):
        readers = [1 + (d + j) % 7 for j in range(3)]
        ratings = [10 * d + j + 1 for j in range(3)]   # all distinct
        docs.append(Document(terms=[1, 2], counts=[1, 1],
                             readers=readers, ratings=list(ratings)))
    corp = Corpus(docs=docs, vocab={1: "a", 2: "b"},
                  users={u: f"u{u}" for u in range(1, 8)})
    orig = {d: dict(zip(doc.readers, doc.ratings))
            for d, doc in enumerate(corp.docs, start=1)}
    corp2, held = holdout_readers(corp, seed=0)
    assert held
    # default is copy-out: the caller's corpus is untouched
    for d, doc in enumerate(corp.docs, start=1):
        assert len(doc.readers) == 3 and orig[d] == dict(
            zip(doc.readers, doc.ratings))
    for d, doc in enumerate(corp2.docs, start=1):
        for r, rating in zip(doc.readers, doc.ratings):
            assert orig[d][r] == rating
    # inplace=True edits the argument itself (corp_out is corp)
    corp3, held3 = holdout_readers(corp, seed=0, inplace=True)
    assert corp3 is corp and held3 == held
    for d, doc in enumerate(corp.docs, start=1):
        for r, rating in zip(doc.readers, doc.ratings):
            assert orig[d][r] == rating


def test_ranked_users_shared_across_metrics():
    from topicmodelsvb_jl_tpu import (
        CTPF, RuntimeConfig, heldout_reader_rank, holdout_readers,
        ranked_users, recall_at_k, synth_corpus)

    corp = synth_corpus(M=48, V=30, K=3, U=12, seed=5)
    corp, held = holdout_readers(corp, seed=1)
    model = CTPF(corp, 3, runtime=RuntimeConfig(chunk_docs=8))
    model.train(iter=3, checkelbo=float("inf"), printelbo=False)
    recs = ranked_users(model, held)
    r1 = heldout_reader_rank(model, held, recs=recs)
    r2 = heldout_reader_rank(model, held)
    np.testing.assert_array_equal(r1, r2)
    assert recall_at_k(model, held, k=5, recs=recs) == \
        recall_at_k(model, held, k=5)


def test_holdout_readers_skips_duplicated_readers():
    """A reader listed twice in a doc must never be held out: popping one
    copy leaves the user a reader, and heldout_reader_rank would crash on
    row.index (regression)."""
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.evaluate import holdout_readers

    docs = [tm.Document(terms=[1, 2], counts=[1, 1],
                        readers=[3, 3], ratings=[1, 1]),
            tm.Document(terms=[2], counts=[1],
                        readers=[1, 2, 2], ratings=[1, 1, 1])]
    corp = tm.Corpus(docs=docs, vocab={1: "a", 2: "b"},
                     users={1: "u1", 2: "u2", 3: "u3"})
    corp2, held = holdout_readers(corp, seed=0)
    # doc 1: only duplicated readers -> skipped entirely
    # doc 2: reader 1 is the only single-occurrence candidate
    assert held == [(2, 1)]
    assert corp2.docs[0].readers == [3, 3]
    assert corp2.docs[1].readers == [2, 2] and corp2.docs[1].ratings == [1, 1]
    # default copy-out: the caller's docs keep their readers
    assert docs[1].readers == [1, 2, 2]
