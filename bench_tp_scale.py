"""TP-at-scale study.

Two halves:

  python bench_tp_scale.py          large-V single-card LDA: step + ELBO
                                    cost (both ELBO table modes) and
                                    live device memory at
                                    V=250k/1M/2M/4M (K=100)
  python bench_tp_scale.py --shard  8-virtual-device CPU mesh: vocab TP
                                    at V=250k (per-shard beta storage /8,
                                    trajectory equality) and CTPF user TP
                                    at U=500k (he storage /8 + a short
                                    trajectory match + lazy-recs check)

V=2M once failed to compile because of the constructor's gamma
rejection sampler; utils/numerics.py:dirichlet_ones replaced it.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

if "--shard" in sys.argv:
    import sys, os, json
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from topicmodelsvb_jl_tpu.models import lda as lda_mod
    from topicmodelsvb_jl_tpu.ops.packing import PackedCorpus
    from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
    from topicmodelsvb_jl_tpu.parallel.shard import shard_map
    from topicmodelsvb_jl_tpu.utils.numerics import elbo_value

    V, K, M, L, chunk = 250_000, 100, 2048, 64, 256
    rng = np.random.default_rng(0)
    terms = (rng.random((M, L)) ** 3 * V).astype(np.int32)
    counts = (1 + rng.poisson(0.3, (M, L))).astype(np.float32)
    n = rng.integers(L // 2, L, size=M)
    valid = np.arange(L)[None, :] < n[:, None]
    counts *= valid; terms *= valid
    packed = PackedCorpus(terms=terms, counts=counts,
                          doc_mask=np.ones(M, np.float32),
                          N=n.astype(np.int32), C=counts.sum(1),
                          M=M, V=V, L=L, max_count=int(counts.max()))
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask), jnp.asarray(float(M), jnp.float32))

    # single-device reference
    st0 = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float32)
    kw = dict(viter=5, vtol=1e-4, niter=50, ntol=1e-4)
    step1 = jax.jit(lda_mod.make_step(packed, K, chunk_docs=chunk,
                                      axis_name=None, use_pallas=False, **kw))
    ref = st0
    for _ in range(2):
        ref = step1(ref, *data)
    e1 = elbo_value(jax.jit(lda_mod.make_elbo(packed, K, chunk_docs=chunk))(
        ref, *data[:3]))

    # 8-device data x vocab TP (beta storage sharded /8 over V)
    mesh = make_mesh(axis_names=("data", "vocab"), shape=(1, 8))
    axes = ("data", "vocab")
    spec = lda_mod.partition_spec(data_axis=axes, vocab_axis="vocab")
    d = P(axes)
    step8 = jax.jit(shard_map(
        lda_mod.make_step(packed, K, chunk_docs=chunk, axis_name=axes,
                          vocab_axis="vocab", use_pallas=False, **kw),
        mesh=mesh, in_specs=(spec, d, d, d, P()), out_specs=spec,
        check_vma=False))
    elbo8 = jax.jit(shard_map(
        lda_mod.make_elbo(packed, K, chunk_docs=chunk, axis_name=axes,
                          vocab_axis="vocab"),
        mesh=mesh, in_specs=(spec, d, d, d), out_specs=P(), check_vma=False))
    from jax.sharding import NamedSharding
    st8 = jax.device_put(st0, jax.tree_util.tree_map(
        lambda sp: NamedSharding(mesh, sp), spec))
    s = st8
    for _ in range(2):
        s = step8(s, *data)
    e8 = elbo_value(elbo8(s, *data[:3]))

    shard = s.beta.addressable_shards[0].data
    print(json.dumps(dict(
        V=V, K=K,
        beta_full_MB=round(K * V * 4 / 1e6, 1),
        beta_per_shard_MB=round(np.prod(shard.shape) * 4 / 1e6, 1),
        shard_shape=list(shard.shape),
        elbo_single=e1, elbo_tp8=e8,
        rel_elbo_diff=abs(e8 - e1) / abs(e1),
        beta_rel_err=float(np.max(np.abs(
            np.asarray(s.beta) - np.asarray(ref.beta))
            / (np.abs(np.asarray(ref.beta)) + 1e-12))))), flush=True)

    # CTPF user-axis TP at U=500k: he storage sharded /8 over users
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.models import ctpf as ctpf_mod
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus

    U = 500_000
    corp = tm.synth_corpus(M=512, V=2000, K=10, U=64, seed=1, mean_readers=4)
    # re-key readers into a 500k-user universe (synthetic spread)
    rng = np.random.default_rng(2)
    for doc in corp.docs:
        doc.readers[:] = [int(r) for r in
                          1 + rng.choice(U, size=len(doc.readers),
                                         replace=False)]
    corp.users.clear()
    corp.users.update({u + 1: f"u{u + 1}" for u in range(U)})
    cp = pack_corpus(corp, pad_multiple=8, docs_multiple=64, with_readers=True)
    K2 = 16
    cst = ctpf_mod.init(jax.random.PRNGKey(0), cp, K2, jnp.float32)
    cdata = (jnp.asarray(cp.terms), jnp.asarray(cp.counts),
             jnp.asarray(cp.readers), jnp.asarray(cp.ratings),
             jnp.asarray(cp.doc_mask))
    umesh = make_mesh(axis_names=("data", "user"), shape=(1, 8))
    uaxes = ("data", "user")
    uspec = ctpf_mod.partition_spec(data_axis=uaxes, user_axis="user")
    ud = P(uaxes)
    cstep = jax.jit(shard_map(
        ctpf_mod.make_step(cp, K2, viter=4, vtol=1e-3, chunk_docs=64,
                           axis_name=uaxes, user_axis="user"),
        mesh=umesh, in_specs=(uspec, ud, ud, ud, ud, ud), out_specs=uspec,
        check_vma=False))
    cst8 = jax.device_put(cst, jax.tree_util.tree_map(
        lambda sp: NamedSharding(umesh, sp), uspec))

    # single-device reference trajectory (the bar the vocab half meets)
    cstep1 = jax.jit(ctpf_mod.make_step(cp, K2, viter=4, vtol=1e-3,
                                        chunk_docs=64, axis_name=None))
    celbo1 = jax.jit(ctpf_mod.make_elbo(cp, K2, chunk_docs=64))
    cref, cs = cst, cst8
    for _ in range(2):
        cref = cstep1(cref, *cdata)
        cs = cstep(cs, *cdata)
    ce1 = elbo_value(celbo1(cref, *cdata))
    ce8 = elbo_value(celbo1(
        jax.tree_util.tree_map(np.asarray, cs), *cdata))
    hshard = cs.he.addressable_shards[0].data
    rel = lambda a, b: float(np.max(
        np.abs(np.asarray(a) - np.asarray(b))
        / (np.abs(np.asarray(b)) + 1e-12)))
    print(json.dumps(dict(
        U=U, K=K2,
        he_full_MB=round(K2 * cs.he.shape[1] * 4 / 1e6, 1),
        he_per_shard_MB=round(np.prod(hshard.shape) * 4 / 1e6, 1),
        he_shard_shape=list(hshard.shape),
        elbo_single=ce1, elbo_tp8=ce8,
        rel_elbo_diff=abs(ce8 - ce1) / abs(ce1),
        he_rel_err=rel(cs.he, cref.he),
        gimel_rel_err=rel(cs.gimel, cref.gimel))), flush=True)

    # lazy recs at U=500k through the api: the dense [M, U] scores
    # (512×500k = 1 GB f32) must never materialise — rec rows come from
    # O((M+U)·K) matvecs (api.py:_score_row_dev); checked against a
    # NumPy oracle built from the factor state rows only
    model = tm.CTPF(corp, K2, seed=0,
                    runtime=tm.RuntimeConfig(chunk_docs=64, pad_multiple=8))
    model.train(iter=2, tol=0.0, checkelbo=np.inf, printelbo=False)
    assert model._lazy_scores and model._scores_dev is None \
        and model._scores_np is None, "dense scores materialised"
    st = jax.tree_util.tree_map(np.asarray, model.state)
    rows = model._doc_rows()
    etheta = st.gimel / st.dalet[None, :] + st.zayin / st.het[None, :]
    eeta = st.he / st.vav[:, None]
    ok_u = ok_d = 0
    for u in (0, 7, U - 1):
        got = model.urecs[u][:5]
        s_col = etheta @ eeta[:, u]
        order = np.argsort(-s_col[rows], kind="stable")
        excl = set(model.libs[u])
        want = [int(d) + 1 for d in order if int(d) + 1 not in excl][:5]
        ok_u += got == want
    for dd in (0, 3, 11):
        got = model.drecs[dd][:5]
        s_row = etheta[rows[dd]] @ eeta
        order = np.argsort(-s_row[:U], kind="stable")
        excl = set(model.corp.docs[dd].readers)
        want = [int(u) + 1 for u in order if int(u) + 1 not in excl][:5]
        ok_d += got == want
    assert model._scores_dev is None and model._scores_np is None, \
        "lazy rec rows materialised the dense scores"
    print(json.dumps(dict(
        lazy_recs_U=U, urecs_rows_checked=3, urecs_match=ok_u,
        drecs_rows_checked=3, drecs_match=ok_d,
        dense_scores_materialised=False)), flush=True)
    assert ok_u == 3 and ok_d == 3
    print("tp_shard done")

else:
    import sys, json, time
    import numpy as np, jax, jax.numpy as jnp


    def hbm():
        return int(jax.local_devices()[0].memory_stats()["bytes_in_use"])


    def lda_at_V(V, M=32768, K=100, chunk=1024, L=96, iters=3):
        from topicmodelsvb_jl_tpu.models import lda as lda_mod
        from topicmodelsvb_jl_tpu.ops.packing import PackedCorpus
        from topicmodelsvb_jl_tpu.utils.numerics import elbo_value

        rng = np.random.default_rng(0)
        terms = (rng.random((M, L)) ** 3 * V).astype(np.int32)
        counts = (1 + rng.poisson(0.3, (M, L))).astype(np.float32)
        n = rng.integers(L // 2, L, size=M)
        valid = np.arange(L)[None, :] < n[:, None]
        counts *= valid; terms *= valid
        packed = PackedCorpus(terms=terms, counts=counts,
                              doc_mask=np.ones(M, np.float32),
                              N=n.astype(np.int32), C=counts.sum(1),
                              M=M, V=V, L=L, max_count=int(counts.max()))
        base = hbm()
        state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float32)
        step = jax.jit(lda_mod.make_step(packed, K, viter=10, vtol=1e-4,
                                         niter=100, ntol=1e-4,
                                         chunk_docs=chunk, axis_name=None))
        elbo = jax.jit(lda_mod.make_elbo(packed, K, chunk_docs=chunk))
        data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
                jnp.asarray(packed.doc_mask),
                jnp.asarray(float(M), jnp.float32))
        state = step(state, *data)          # compile + warm
        float(state.beta[0, 0])             # value fetch = real sync
        peak0 = hbm()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            s2 = state
            for _ in range(iters):
                s2 = step(s2, *data)
            float(s2.beta[0, 0])            # value fetch cannot return early
            times.append((time.perf_counter() - t0) / iters)
        step_s = float(np.median(times))
        def time_elbo(fn):
            elbo_value(fn(state, *data[:3]))  # compile
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                ev = elbo_value(fn(state, *data[:3]))
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts)), ev

        elbo_s, ev = time_elbo(elbo)   # auto mode (what users get)
        # both table modes explicitly, for the crossover measurement;
        # the combined [V, 2Kp] table may legitimately OOM at the
        # largest V — that is the regime gather_direct exists for
        gd_s = time_elbo(jax.jit(lda_mod.make_elbo(
            packed, K, chunk_docs=chunk, gather_direct=True)))[0]
        try:
            ct_s = time_elbo(jax.jit(lda_mod.make_elbo(
                packed, K, chunk_docs=chunk, gather_direct=False)))[0]
        except Exception as e:
            print(f"combined-table ELBO failed at V={V}: "
                  f"{type(e).__name__}", flush=True)
            ct_s = None
        beta_mb = 2 * K * V * 4 / 1e6
        table_mb = V * 2 * ((K + 127) // 128 * 128) * 4 / 1e6
        out = dict(V=V, M=M, step_s=round(step_s, 4),
                   elbo_s=round(elbo_s, 4),
                   elbo_s_gather_direct=round(gd_s, 4),
                   elbo_s_combined_table=(None if ct_s is None
                                          else round(ct_s, 4)),
                   elbo=round(ev, 1), beta_pair_MB=round(beta_mb, 1),
                   elbo_table_MB=round(table_mb, 1),
                   hbm_in_use_MB=round(hbm() / 1e6, 1),
                   hbm_after_step_MB=round(peak0 / 1e6, 1))
        print(json.dumps(out), flush=True)
        return out


    # --v N runs a single vocabulary size (e.g. the V=6M ceiling row
    # alone — the full grid takes ~15 min of compiles)
    if "--v" in sys.argv:
        grid = (int(sys.argv[sys.argv.index("--v") + 1]),)
    else:
        grid = (250_000, 1_000_000, 2_000_000, 4_000_000, 6_000_000)
    for V in grid:
        try:
            lda_at_V(V)
        except Exception as e:
            print(json.dumps(dict(V=V, error=str(e)[:300])), flush=True)
            break
