"""The contractions that oracle parity depends on carry HIGHEST precision
in their jaxprs, so an f32 dot never runs in TF32 on a GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topicmodelsvb_jl_tpu.ops.packing import PackedCorpus


def _packed(M=16, V=20, L=8, seed=0):
    rng = np.random.default_rng(seed)
    terms = rng.integers(0, V, size=(M, L)).astype(np.int32)
    counts = np.ones((M, L), np.float32)
    return PackedCorpus(
        terms=terms, counts=counts, doc_mask=np.ones(M, np.float32),
        N=np.full(M, L, np.int32), C=counts.sum(1), M=M, V=V, L=L,
        max_count=1)


def _precisions(jaxpr):
    """Precision of every dot_general in ``jaxpr`` and its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn.params["precision"]
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    yield from _precisions(sub)


def _dots(closed):
    """(number of dot_general eqns, number of them at HIGHEST)."""
    hi = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    ps = list(_precisions(closed.jaxpr))
    return len(ps), sum(p == hi for p in ps)


def _family_fns(name, packed, K):
    from topicmodelsvb_jl_tpu.models import ctm, dtm, fctm, hmtm, lda

    f32 = jnp.float32
    M = jnp.asarray(float(packed.M), f32)
    d3 = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
          jnp.asarray(packed.doc_mask))
    kw = dict(viter=2, vtol=1e-3, niter=3, ntol=1e-3, chunk_docs=8)
    if name == "ctm":
        st = ctm.init(jax.random.PRNGKey(0), packed, K, f32)
        return [(ctm.make_step(packed, K, **kw), (st, *d3, M)),
                (ctm.make_elbo(packed, K, chunk_docs=8), (st, *d3))]
    if name == "fctm":
        st = fctm.init(jax.random.PRNGKey(0), packed, K, f32)
        return [(fctm.make_step(packed, K, **kw), (st, *d3, M)),
                (fctm.make_elbo(packed, K, chunk_docs=8), (st, *d3))]
    if name == "hmtm":
        st = hmtm.init(jax.random.PRNGKey(0), packed, K, f32)
        return [(hmtm.make_step(packed, K, **kw), (st, *d3, M))]
    if name == "dtm":
        T = 2
        sid = jnp.asarray(np.arange(packed.M_pad) % T, jnp.int32)
        st = dtm.init(jax.random.PRNGKey(0), packed, K, T, f32)
        return [(dtm.make_step(packed, K, T, cgiter=2, cgtol=1e-3, **kw),
                 (st, sid, *d3))]
    st = lda.init(jax.random.PRNGKey(0), packed, K, f32)
    return [(lda.make_step(packed, K, use_pallas=False, **kw), (st, *d3, M)),
            (lda.make_elbo(packed, K, chunk_docs=8), (st, *d3))]


@pytest.mark.parametrize("family", ["ctm", "fctm", "hmtm", "dtm", "lda"])
def test_step_contractions_at_highest(family):
    packed = _packed()
    for fn, args in _family_fns(family, packed, K=3):
        n, hi = _dots(jax.make_jaxpr(fn)(*args))
        assert n > 0 and hi == n, (family, n, hi)


def test_pcg_matvec_at_highest():
    from topicmodelsvb_jl_tpu.ops.newton import spd_cg_solve

    A = jnp.eye(4, dtype=jnp.float32) * 2.0
    b = jnp.ones((3, 4), jnp.float32)
    fn = lambda b: spd_cg_solve(lambda x: x @ A, b, jnp.full((3, 4), 0.5),
                                jnp.ones((3,), bool), 6, 1e-6)
    n, hi = _dots(jax.make_jaxpr(fn)(b))
    assert n > 0 and hi == n
