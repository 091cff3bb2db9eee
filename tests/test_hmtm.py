"""HMTM correctness: oracle parity, ELBO monotonicity, shard equivalence,
order-sensitivity recovery, predict/gendoc surface.

The reference never finished this model (HMTM/HMTM.jl:186-187 —
``updatePhi!`` is empty); the structured-VB completion is validated
against its own float64 per-doc NumPy oracle (tests/oracle.py), the same
bar every finished reference model is held to.
"""

import numpy as np
import pytest

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig

from oracle import HMTMOracle, docs_from_corpus


def _make(corp, K, n_devices=None, dtype="float64", chunk=8, seed=3):
    from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices=n_devices)
    rt = RuntimeConfig(chunk_docs=chunk, dtype=dtype, pad_multiple=8)
    return tm.HMTM(corp, K, runtime=rt, mesh=mesh, seed=seed)


def test_hmtm_matches_oracle(ordered_corpus):
    """Batched forward-backward E-step + Newtons reproduce the per-doc
    float64 oracle trajectory update-by-update."""
    K, iters = 4, 5
    model = _make(ordered_corpus, K)
    beta0 = np.asarray(model.state.beta, np.float64)

    oracle = HMTMOracle(docs_from_corpus(ordered_corpus),
                        V=ordered_corpus.shape[1], K=K, beta0=beta0)
    oracle_elbos = oracle.train(iters)

    model.train(iter=iters, checkelbo=1, printelbo=False)

    np.testing.assert_allclose(model.beta, oracle.beta, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(model.eta, oracle.eta, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(model.alpha, oracle.alpha, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(model.tau, np.stack(oracle.tau),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(model.gamma, np.stack(oracle.gamma),
                               rtol=1e-7, atol=1e-9)
    traced = [r.elbo for r in model.trainer.trace if r.elbo is not None]
    np.testing.assert_allclose(traced, oracle_elbos, rtol=1e-8)


def test_hmtm_elbo_monotone(ordered_corpus):
    model = _make(ordered_corpus, K=5)
    model.train(iter=15, checkelbo=1, printelbo=False)
    deltas = [r.delta_elbo for r in model.trainer.trace
              if r.delta_elbo is not None]
    assert len(deltas) >= 10     # not vacuous if tracing regresses
    assert all(d > -1e-6 for d in deltas[1:])


@pytest.mark.slow
def test_hmtm_shard_equivalence(ordered_corpus):
    m1 = _make(ordered_corpus, K=4, n_devices=1, seed=3)
    m8 = _make(ordered_corpus, K=4, n_devices=8, seed=3)
    m1.train(iter=4, checkelbo=1, printelbo=False)
    m8.train(iter=4, checkelbo=1, printelbo=False)
    np.testing.assert_allclose(m1.beta, m8.beta, rtol=1e-9)
    np.testing.assert_allclose(m1.eta, m8.eta, rtol=1e-8)
    np.testing.assert_allclose(m1.alpha, m8.alpha, rtol=1e-8)
    np.testing.assert_allclose(m1.elbo, m8.elbo, rtol=1e-9)


def _sticky_corpus(M=40, K=2, V=30, N=40, stay=0.97, seed=0):
    """Ordered corpus from the HMTM generative story with topic-disjoint
    vocabularies and a sticky (diagonal-dominant) transition chain."""
    rng = np.random.default_rng(seed)
    half = V // K
    betas = []
    for k in range(K):
        b = np.full(V, 1e-6)
        b[k * half:(k + 1) * half] = 1.0
        betas.append(b / b.sum())
    docs = []
    for _ in range(M):
        z = rng.integers(K)
        terms = []
        for _n in range(N):
            if rng.random() > stay:
                z = (z + 1) % K
            terms.append(int(rng.choice(V, p=betas[z])) + 1)
        docs.append(tm.Document(terms=terms, counts=[1] * N))
    vocab = {j + 1: f"w{j + 1}" for j in range(V)}
    return tm.Corpus(docs=docs, vocab=vocab), np.stack(betas)


def test_hmtm_recovers_sticky_transitions():
    """On data with near-block topic runs the model must (a) recover the
    topic-word structure and (b) learn diagonal-dominant per-doc
    transition expectations — the order-sensitivity LDA cannot express."""
    corp, true_beta = _sticky_corpus()
    model = _make(corp, K=2, chunk=8, seed=1)
    model.train(iter=30, checkelbo=5, printelbo=False)

    # align learned topics to truth by best cosine
    b = model.beta
    sims = true_beta @ b.T / (
        np.linalg.norm(true_beta, axis=1)[:, None] * np.linalg.norm(b, axis=1))
    perm = sims.argmax(axis=1)
    assert sorted(perm.tolist()) == [0, 1]
    assert sims[0, perm[0]] > 0.95 and sims[1, perm[1]] > 0.95

    # expected transitions: diagonal mass must dominate in (almost)
    # every document — the chain is 97% sticky
    trans = model.transdist(list(range(1, model.M + 1)))  # [M, K, K]
    diag = trans[:, perm[0], perm[0]] + trans[:, perm[1], perm[1]]
    off = trans[:, perm[0], perm[1]] + trans[:, perm[1], perm[0]]
    assert np.mean(diag > off) > 0.9
    assert float(np.mean(diag / 2)) > 0.7

    # the prior alpha itself should have learned the stickiness
    a = model.alpha
    a = a / a.sum(axis=0, keepdims=True)
    assert a[perm[0], perm[0]] > a[perm[1], perm[0]]
    assert a[perm[1], perm[1]] > a[perm[0], perm[1]]


def test_hmtm_predict_and_surface(ordered_corpus):
    model = _make(ordered_corpus, K=3)
    model.train(iter=3, checkelbo=np.inf, printelbo=False)

    td = model.topicdist(1)
    assert td.shape == (3,) and np.isclose(td.sum(), 1.0)
    tr = model.transdist(1)
    assert tr.shape == (3, 3)
    np.testing.assert_allclose(tr.sum(axis=0), 1.0, rtol=1e-9)

    new = tm.predict(ordered_corpus, model, iter=5)
    assert isinstance(new, tm.HMTM)
    # globals frozen, per-doc state fit
    np.testing.assert_array_equal(new.beta, model.beta)
    np.testing.assert_array_equal(new.eta, model.eta)
    td2 = new.topicdist(list(range(1, new.M + 1)))
    assert td2.shape == (new.M, 3)
    assert np.all(np.isfinite(td2))


def test_hmtm_gendoc_ordered(ordered_corpus):
    model = _make(ordered_corpus, K=3)
    model.train(iter=2, checkelbo=np.inf, printelbo=False)
    doc = tm.gendoc(model, laplace_smooth=1e-3,
                    rng=np.random.default_rng(0))
    assert len(doc.terms) == len(doc.counts)
    assert all(c == 1 for c in doc.counts)          # ordered tokens
    assert all(1 <= t <= ordered_corpus.shape[1] for t in doc.terms)


@pytest.mark.slow
def test_hmtm_checkpoint_roundtrip(ordered_corpus, tmp_path):
    model = _make(ordered_corpus, K=3)
    model.train(iter=2, checkelbo=1, printelbo=False)
    path = str(tmp_path / "hmtm_ckpt")
    tm.save_checkpoint(path, model)
    loaded = tm.load_checkpoint(path, ordered_corpus)
    assert isinstance(loaded, tm.HMTM)
    np.testing.assert_array_equal(loaded.beta, model.beta)
    np.testing.assert_array_equal(loaded.gamma, model.gamma)
    # resumed training continues the same trajectory
    model.train(iter=1, checkelbo=1, printelbo=False)
    loaded.train(iter=1, checkelbo=1, printelbo=False)
    np.testing.assert_allclose(loaded.elbo, model.elbo, rtol=1e-10)


def test_hmtm_check_model_catches_corruption(ordered_corpus):
    model = _make(ordered_corpus, K=3)
    bad = np.asarray(model.state.tau).copy()
    bad[0, 0] = -1.0
    model.state = model.state._replace(tau=bad)
    with pytest.raises(tm.TopicModelError):
        model.train(iter=1, printelbo=False)


def test_hmtm_rejects_condensed_corpus():
    """HMTM ignores counts (HMTM.jl:63-67); a condensed corpus must be
    rejected loudly, not silently fit with multiplicity destroyed."""
    corp = tm.synth_corpus(M=16, V=20, K=2, seed=0)
    tm.condense_corp(corp)
    assert any(c > 1 for doc in corp.docs for c in doc.counts), \
        "fixture should actually contain a repeated term"
    with pytest.raises(ValueError, match="order-preserving"):
        tm.HMTM(corp, 2)
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=8)
    with pytest.raises(ValueError, match="order-preserving"):
        tm.StreamingHMTM(packed, 2, batch_docs=16, chunk_docs=8)


def _ppl_pair(train_corp, test_corp, K=2, seed=3):
    """(hmtm_ppl, lda_ppl) fit on train_corp, scored on test_corp."""
    from topicmodelsvb_jl_tpu.evaluate import perplexity

    rt = RuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8)
    h = tm.HMTM(train_corp, K, runtime=rt, seed=seed)
    h.train(iter=30, tol=0.0, checkelbo=np.inf, printelbo=False)
    l = tm.LDA(train_corp, K, runtime=rt, seed=seed)
    l.train(iter=30, tol=0.0, checkelbo=np.inf, printelbo=False)
    return (perplexity(test_corp, h), perplexity(test_corp, l))


def _shuffled(corp, seed=0):
    rng = np.random.default_rng(seed)
    docs = [tm.Document(terms=[int(t) for t in
                               rng.permutation(np.asarray(d.terms))],
                        counts=[1] * len(d.terms))
            for d in corp.docs]
    return tm.Corpus(docs=docs, vocab=dict(corp.vocab))


@pytest.mark.slow
def test_hmtm_beats_lda_on_chains_ties_when_shuffled():
    """The model family's VALUE gate: order-aware
    perplexity must beat LDA by a margin on sticky-chain corpora —
    word order carries topic structure, the model's whole motivation
    (HMTM/HMTMREADME.md) — and must TIE on the same corpora with each
    document's tokens shuffled (no order signal left to exploit)."""
    # K=3 topic-disjoint vocabularies: an order-blind mixture must pay
    # the ~1/3 topic-uncertainty per token that the chain resolves, so
    # the HMTM margin is structural, not threshold-tuned
    train, _ = _sticky_corpus(M=80, K=3, N=60, seed=1)
    test, _ = _sticky_corpus(M=40, K=3, N=60, seed=2)

    h_ppl, l_ppl = _ppl_pair(train, test, K=3)
    assert h_ppl < 0.8 * l_ppl, (
        f"HMTM ({h_ppl:.2f}) must beat LDA ({l_ppl:.2f}) by a margin "
        "on sticky chains")

    h_s, l_s = _ppl_pair(_shuffled(train, 3), _shuffled(test, 4), K=3)
    assert 0.85 * l_s <= h_s <= 1.15 * l_s, (
        f"shuffled corpora must tie: HMTM {h_s:.2f} vs LDA {l_s:.2f}")
