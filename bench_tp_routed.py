"""Routed vocab-TP: per-device step cost, measured on one card.

The all-gather TP design shards beta storage only (a memory lever, not
a time lever).  Routed TP (ops/packing.route_packed + models/lda.make_step
``vocab_routed``) is the design that divides the per-device *work*:
each device owns a contiguous [V/n, K] beta block and receives exactly
the token slots that block serves, so the E-step gather table, the stat
scatter, and the M-step normalize are all O(V/n) per device and beta is
never all-gathered.  Added communication: a [B, K] psum per viter
iteration (the seq-axis pattern) + one [K] row-sum psum per sweep.

On one card this measures the single-card surrogate: the WORST-fill shard's per-device program (its local vocab
block + its routed token slots, every doc) executed standalone, vs the
full unrouted step at the same V.  The surrogate is compute-exact for
the per-device program (the doc-level work is replicated in both); the
psum cost it cannot include is reported as arithmetic bytes/iter.
Trajectory correctness of the full routed collective path is CI's job
(tests/test_parallel.py::test_vocab_routed_tp_matches_single_device on
the 8-virtual-device mesh).

Two id distributions per V: "uniform" (dictionary-keyed corpora — the
common case) and the grid's usual cube-skew ("zipf-ish"), where
contiguous-block ownership is IMBALANCED (half the tokens land in
block 0) — the fill/Ls columns quantify what imbalance costs, since
every device pays the max-shard padded width.

Usage: python bench_tp_routed.py [--v N] [--shards S]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import jax
import jax.numpy as jnp

from topicmodelsvb_jl_tpu.models import lda as lda_mod
from topicmodelsvb_jl_tpu.ops.packing import PackedCorpus, route_packed


def synth(V, M, L, skew, seed=0):
    rng = np.random.default_rng(seed)
    if skew == "uniform":
        terms = rng.integers(0, V, size=(M, L)).astype(np.int32)
    else:  # the tp-scale grid's cube-skew (frequency-sorted-ids worst case)
        terms = (rng.random((M, L)) ** 3 * V).astype(np.int32)
    counts = (1 + rng.poisson(0.3, (M, L))).astype(np.float32)
    n = rng.integers(L // 2, L, size=M)
    valid = np.arange(L)[None, :] < n[:, None]
    counts *= valid
    terms *= valid
    return PackedCorpus(terms=terms, counts=counts,
                        doc_mask=np.ones(M, np.float32),
                        N=n.astype(np.int32), C=counts.sum(1),
                        M=M, V=V, L=L, max_count=int(counts.max()))


def time_step(packed, K, chunk, iters=3, reps=3):
    state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float32)
    step = jax.jit(lda_mod.make_step(packed, K, viter=10, vtol=1e-4,
                                     niter=100, ntol=1e-4,
                                     chunk_docs=chunk, axis_name=None))
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask),
            jnp.asarray(float(packed.M), jnp.float32))
    state = step(state, *data)
    float(state.beta[0, 0])
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        s2 = state
        for _ in range(iters):
            s2 = step(s2, *data)
        float(s2.beta[0, 0])
        times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times))


def run(V, S, M=32768, K=100, L=96, chunk=1024):
    for skew in ("uniform", "zipfish"):
        packed = synth(V, M, L, skew)
        routed = route_packed(packed, n_shards=S, pad_multiple=8)
        # worst shard by real (count>0) slots — the device every other
        # shard waits for; its padded width Ls is what all devices pay
        per_shard = [
            float((routed.counts[:, s * routed.Ls:(s + 1) * routed.Ls] > 0
                   ).sum()) for s in range(S)]
        worst = int(np.argmax(per_shard))
        blk = slice(worst * routed.Ls, (worst + 1) * routed.Ls)
        shard_packed = PackedCorpus(
            terms=routed.terms[:, blk].copy(),
            counts=routed.counts[:, blk].copy(),
            doc_mask=routed.doc_mask, N=routed.N, C=routed.C,
            M=routed.M, V=routed.Vs, L=routed.Ls,
            max_count=int(routed.counts.max()))
        full_s = time_step(packed, K, chunk)
        dev_s = time_step(shard_packed, K, chunk)
        # per-viter [B,K] doc-stat psum over the vocab axis, per sweep
        psum_mb = routed.M_pad / chunk * 10 * chunk * K * 4 / 1e6
        print(json.dumps(dict(
            V=V, shards=S, skew=skew,
            Ls=routed.Ls, fill=round(routed.fill, 3),
            worst_shard_tokens=int(per_shard[worst]),
            mean_shard_tokens=int(np.mean(per_shard)),
            step_s_full=round(full_s, 4),
            step_s_routed_per_device=round(dev_s, 4),
            speedup_vs_full=round(full_s / dev_s, 2),
            psum_traffic_MB_per_sweep=round(psum_mb, 1),
        )), flush=True)


if __name__ == "__main__":
    S = (int(sys.argv[sys.argv.index("--shards") + 1])
         if "--shards" in sys.argv else 8)
    grid = ((int(sys.argv[sys.argv.index("--v") + 1]),)
            if "--v" in sys.argv else (1_000_000, 4_000_000))
    for V in grid:
        try:
            run(V, S)
        except Exception as e:
            print(json.dumps(dict(V=V, error=str(e)[:300])), flush=True)
            break
