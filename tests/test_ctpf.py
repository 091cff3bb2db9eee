"""CTPF correctness: oracle parity (including the ELBO
binomial-cancellation identity), recommender outputs, degenerate paths."""

import numpy as np

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.api import CTPF
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig

from oracle import CTPFOracle, ctpf_docs_from_corpus


def _make(corp, K, dtype="float64", chunk=8, seed=3, n_devices=None):
    from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices=n_devices)
    rt = RuntimeConfig(chunk_docs=chunk, dtype=dtype, pad_multiple=8)
    return CTPF(corp, K, runtime=rt, mesh=mesh, seed=seed)


def test_ctpf_matches_cpu_oracle(reader_corpus):
    """Parity with the float64 transliteration — including the ELBO, which
    proves the E[lnΓ(y+1)] cancellation used on device equals the
    reference's explicit binomial-pdf sums."""
    K, iters = 3, 3
    model = _make(reader_corpus, K)
    alef0 = np.asarray(model.state.alef, np.float64)

    M, V, U = reader_corpus.shape
    oracle = CTPFOracle(ctpf_docs_from_corpus(reader_corpus), V=V, U=U, K=K,
                        alef0=alef0)
    oracle_elbos = oracle.train(iters)

    model.train(iter=iters, checkelbo=1, printelbo=False)

    np.testing.assert_allclose(model.alef, oracle.alef, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(model.he, oracle.he, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(model.bet, oracle.bet, rtol=1e-7)
    np.testing.assert_allclose(model.vav, oracle.vav, rtol=1e-7)
    np.testing.assert_allclose(model.dalet, oracle.dalet, rtol=1e-7)
    np.testing.assert_allclose(model.het, oracle.het, rtol=1e-7)
    np.testing.assert_allclose(model.gimel, np.stack(oracle.gimel), rtol=1e-6)
    np.testing.assert_allclose(model.zayin, np.stack(oracle.zayin), rtol=1e-6)
    traced = [r.elbo for r in model.trainer.trace if r.elbo is not None]
    np.testing.assert_allclose(traced, oracle_elbos, rtol=1e-7)


def test_ctpf_elbo_monotone(reader_corpus):
    model = _make(reader_corpus, K=4)
    model.train(iter=10, checkelbo=1, printelbo=False)
    deltas = [r.delta_elbo for r in model.trainer.trace if r.delta_elbo is not None]
    assert all(d > -1e-6 for d in deltas[1:])


def test_ctpf_shard_equivalence(reader_corpus):
    m1 = _make(reader_corpus, K=3, n_devices=1)
    m8 = _make(reader_corpus, K=3, n_devices=8)
    m1.train(iter=3, checkelbo=1, printelbo=False)
    m8.train(iter=3, checkelbo=1, printelbo=False)
    np.testing.assert_allclose(m1.alef, m8.alef, rtol=1e-9)
    np.testing.assert_allclose(m1.he, m8.he, rtol=1e-9)
    np.testing.assert_allclose(m1.elbo, m8.elbo, rtol=1e-9)


def test_ctpf_recommender_outputs(reader_corpus):
    model = _make(reader_corpus, K=3)
    model.train(iter=5, checkelbo=np.inf, printelbo=False)
    M, V, U = reader_corpus.shape
    assert model.scores.shape == (M, U)
    # drecs/urecs are permutations of the non-reader/non-lib complements
    for d, doc in enumerate(reader_corpus.docs):
        assert sorted(model.drecs[d]) == sorted(
            set(range(1, U + 1)) - set(doc.readers)
        )
        # ranked descending by score
        s = model.scores[d, np.array(model.drecs[d]) - 1]
        assert np.all(np.diff(s) <= 1e-12)
    for u in range(U):
        assert sorted(model.urecs[u]) == sorted(
            set(range(1, M + 1)) - set(model.libs[u])
        )
    # libs invert readers
    for d, doc in enumerate(reader_corpus.docs, start=1):
        for u in doc.readers:
            assert d in model.libs[u - 1]


def test_ctpf_lazy_scores_match_dense(reader_corpus, monkeypatch):
    """Past _SCORES_DENSE_MAX the dense [M, U] score matrix is never
    built (large-U regime, CTPF.jl:60): rec rows come from per-row
    matvecs (api.py:_score_row_dev) and must equal the dense path's."""
    dense = _make(reader_corpus, K=3, dtype="float32")
    dense.train(iter=5, checkelbo=np.inf, printelbo=False)
    assert not dense._lazy_scores

    monkeypatch.setattr(CTPF, "_SCORES_DENSE_MAX", 0)
    lazy = _make(reader_corpus, K=3, dtype="float32")
    lazy.train(iter=5, checkelbo=np.inf, printelbo=False)
    assert lazy._lazy_scores
    assert lazy._scores_dev is None and lazy._scores_np is None

    M, V, U = reader_corpus.shape
    for d in range(M):
        assert lazy.drecs[d] == dense.drecs[d]
    for u in range(U):
        assert lazy.urecs[u] == dense.urecs[u]
    # per-row reads leave the dense matrix unmaterialised
    assert lazy._scores_dev is None and lazy._scores_np is None
    # an explicit .scores ask still yields the full matrix
    np.testing.assert_allclose(lazy.scores, dense.scores, rtol=1e-6)


def _structured_reader_corpus(n_groups=10, docs_per_group=15,
                              users_per_group=20, readers_per_doc=6,
                              V=100, seed=2):
    """Planted collaborative structure with POWER-LAW concentrated user
    libraries: group-g users read group-g docs, drawn Zipf-style within
    the group (a few heavy readers own most of each library) — matching
    real citation data's concentration (reference README.md:541-580,
    where CiteULike's structure yields top ~2%% held-out ranks).  The
    oracle ceiling of this generator is <=5th percentile: a held-out
    reader is drawn proportionally to activity, and ranking users by
    true group affinity x activity places it in the top few of ~190
    non-readers."""
    rng = np.random.default_rng(seed)
    docs = []
    U = n_groups * users_per_group
    # Zipf weights within each group: w_r \propto 1/(r+1)^1.2
    w = 1.0 / (np.arange(users_per_group) + 1.0) ** 1.2
    w /= w.sum()
    for gidx in range(n_groups):
        perm = rng.permutation(users_per_group)  # which users are heavy
        for _ in range(docs_per_group):
            ids = rng.choice(V // n_groups, size=6, replace=False) \
                + gidx * (V // n_groups) + 1
            rd = rng.choice(users_per_group, size=readers_per_doc,
                            replace=False, p=w)
            readers = (perm[rd] + gidx * users_per_group + 1).tolist()
            docs.append(tm.Document(
                terms=ids.tolist(), counts=(1 + rng.poisson(1.0, 6)).tolist(),
                readers=readers, ratings=[1] * readers_per_doc,
            ))
    vocab = {j + 1: f"t{j + 1}" for j in range(V)}
    users = {u + 1: f"u{u + 1}" for u in range(U)}
    return tm.Corpus(docs=docs, vocab=vocab, users=users)


def test_ctpf_heldout_reader_rank():
    """Leave-one-reader-out quality gate (reference README.md:512-560,
    plots.R:20-31): with power-law concentrated libraries the held-out
    reader must land in the top 5%% of non-readers (median), so a 2x
    quality regression is detectable — the old diffuse-synthetic gate
    (<25%% mean) could not see one.  (The protocol is
    the library's evaluate.holdout_readers / heldout_reader_rank —
    the reference's own.)"""
    from topicmodelsvb_jl_tpu.evaluate import (
        heldout_reader_rank, holdout_readers, recall_at_k)

    corp = _structured_reader_corpus()
    corp, held = holdout_readers(corp, seed=11)
    assert held
    model = _make(corp, K=10)
    model.train(iter=40, checkelbo=np.inf, printelbo=False)
    ranks = heldout_reader_rank(model, held)
    med = float(np.median(ranks))
    assert med <= 0.05, f"median held-out reader rank {med:.3f} > 5%"
    # the mean should also beat random (0.5) by an order of magnitude
    assert np.mean(ranks) < 0.15, np.mean(ranks)
    assert recall_at_k(model, held, k=20) > 0.6


def test_ctpf_online_one_pass_heldout_rank():
    """ONE online (SVI) pass over a power-law reader corpus must already
    pass the same ≤5%% median held-out-rank gate the batch model meets
    with 40 full sweeps — the point of stochastic updates on large
    corpora."""
    from topicmodelsvb_jl_tpu.evaluate import (
        heldout_reader_rank, holdout_readers, recall_at_k)
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus
    from topicmodelsvb_jl_tpu.streaming import StreamingCTPF

    corp = _structured_reader_corpus(docs_per_group=50)
    corp, held = holdout_readers(corp, seed=11)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=32,
                         with_readers=True, dtype=np.float64)
    s = StreamingCTPF(packed, 10, batch_docs=32, chunk_docs=16,
                      dtype="float64", seed=3)
    s.train_online(epochs=1, tau0=1.0, kappa=0.7, checkelbo=np.inf,
                   printelbo=False)
    ranks = heldout_reader_rank(s, held)
    med = float(np.median(ranks))
    assert med <= 0.05, f"one-pass median held-out rank {med:.3f} > 5%"
    assert recall_at_k(s, held, k=20) > 0.6


def test_ctpf_no_users_degenerate(tiny_corpus):
    """U==0 corpus: CTPF degrades to Poisson LDA (guards at
    modelutils.jl:483-493, gpuCTPF.jl:448,666)."""
    model = _make(tiny_corpus, K=3)
    model.train(iter=3, checkelbo=1, printelbo=False)
    assert np.isfinite(model.elbo)
    assert model.scores.shape == (len(tiny_corpus), 0)
    assert np.all(model.alef > 0)


def test_ctpf_show_smoke(reader_corpus, capsys):
    model = _make(reader_corpus, K=3)
    model.train(iter=2, checkelbo=np.inf, printelbo=False)
    model.showlibs(1)
    model.showdrecs(1, U=3)
    model.showurecs(1, M=3)
    model.showtopics(V=3, cols=3)
    out = capsys.readouterr().out
    assert "User 1" in out and "Document" in out and "topic 1" in out
