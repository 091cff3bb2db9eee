#!/usr/bin/env python
"""Benchmark harness.

Headline metric: LDA K=100 docs/sec at NSF scale (128,804 docs, 25,319
vocab — reference README.md:34-37), timed over whole outer CAVI
iterations (viter=10 E-step fixpoint + sufficient stats + beta M-step +
alpha Newton) through the public api path — the same step the CLI
drives; the equivalent one-command run is:

    python -m topicmodelsvb_jl_tpu.train --model lda --corpus nsf-scale \\
        --k 100 --iter 10 --checkelbo inf --json

Baseline for ``vs_baseline``: the reference's OpenCL gpuLDA wall-clock —
10 iterations on NSF at K=50 in 26 s (plots.R:4) ⇒ 49,540 docs/s.  We
run the *harder* K=100 configuration and compare against that figure.

The NSF docfile is not shipped, so documents are synthesized at the
published scale with a Zipf-like vocab distribution and realistic doc
lengths, seed-controlled (datasets.synth_packed_nsf_scale).

Timing: every timed chain restarts from the SAME warmed state (identical
work per chain — per-doc convergence masking means a chain continuing
from a converged state does less work), and the result is the median of
the chains.  Each chain ends by fetching a scalar computed from the
final state, so the host clock stops only after the device has finished.

Every line printed names the device it ran on (``platform``,
``device_kind``, ``device_count``).  Modes:

  python bench.py                the LDA headline: one JSON line
  python bench.py --estep-ab     LDA K=100 end to end with the fused
                                 E-step kernel against the XLA body,
                                 chains alternating kernel, XLA, XLA,
                                 kernel, ...; one JSON line with both
                                 medians
  python bench.py --sweep-dist   sensitivity of the LDA headline to the
                                 synthetic vocab draw: one JSON line per
                                 skew exponent (1.5 flatter / 3 Zipf-u^3
                                 headline / 5 spikier)
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# kept for bench_ctm.py / external scripts
from topicmodelsvb_jl_tpu.datasets import synth_packed_nsf_scale as \
    make_packed_nsf_scale  # noqa: E402

BASELINE_DOCS_PER_S = 128_804 * 10 / 26.0  # gpuLDA NSF K=50 (plots.R:4)


def device_fields() -> dict:
    """The device a result was measured on, as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def timed_chains(step, data, warm_state, iters, reps, fetch):
    times = []
    for _ in range(reps):
        s = warm_state
        t0 = time.perf_counter()
        for _ in range(iters):
            s = step(s, *data)
        fetch(s)                      # value fetch = real sync
        times.append(time.perf_counter() - t0)
    return times


def _lda_trainer(packed, K, iters, rt):
    """Warmed (step, data, state) of the api LDA step for ``rt``, and the
    model's packed corpus."""
    import jax
    import jax.numpy as jnp

    from topicmodelsvb_jl_tpu.api import LDA
    from topicmodelsvb_jl_tpu.utils.config import TrainConfig

    model = LDA(packed, K, runtime=rt, seed=7)
    cfg = TrainConfig(iter=iters, checkelbo=float("inf")).resolved(K)
    model._cfg = cfg
    tr = model._build_trainer(cfg)
    state = jax.device_put(model.state, tr.state_sharding)
    # compile + warm up one step; all chains restart from this state
    warm = tr.step_fn(state, *tr.data)
    float(jnp.sum(warm.alpha))
    return tr.step_fn, tr.data, warm, model.packed


def _lda_env():
    return (int(os.environ.get("BENCH_K", 100)),
            int(os.environ.get("BENCH_ITERS", 10)),
            int(os.environ.get("BENCH_CHUNK", 1024)),
            int(os.environ.get("BENCH_M", 128_804)))


def run_lda(reps=None, skew=3.0):
    """LDA headline measurement; returns the result dict."""
    import jax.numpy as jnp

    from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig

    K, iters, chunk, M = _lda_env()
    if reps is None:
        reps = int(os.environ.get("BENCH_REPS", 5))

    packed = make_packed_nsf_scale(M=M, chunk_docs=chunk, skew=skew)
    step, data, warm, _ = _lda_trainer(
        packed, K, iters, RuntimeConfig(chunk_docs=chunk, dtype="float32"))
    times = timed_chains(step, data, warm, iters, reps,
                         lambda s: float(jnp.sum(s.alpha)))
    docs_per_s = packed.M * iters / statistics.median(times)
    tag = "" if skew == 3.0 else f"_skew{skew:g}"
    return {
        "metric": f"lda_k{K}_nsf_estep_docs_per_sec{tag}",
        "value": docs_per_s,
        "unit": "docs/s",
        "vs_baseline": docs_per_s / BASELINE_DOCS_PER_S,
        **device_fields(),
    }


def ab_order(reps: int) -> list:
    """Alternating arm order A, B, B, A, A, B, ... (``reps`` chains each),
    so slow drift of the card's clocks falls on both arms alike."""
    pairs = [("kernel", "xla") if i % 2 == 0 else ("xla", "kernel")
             for i in range(reps)]
    return [arm for pair in pairs for arm in pair]


def run_estep_ab(reps=None):
    """LDA end to end with the fused E-step kernel against the XLA body."""
    import jax.numpy as jnp

    from topicmodelsvb_jl_tpu.models import lda as lda_mod
    from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig

    K, iters, chunk, M = _lda_env()
    if reps is None:
        reps = int(os.environ.get("BENCH_REPS", 5))
    packed = make_packed_nsf_scale(M=M, chunk_docs=chunk)
    arms = {name: _lda_trainer(packed, K, iters, RuntimeConfig(
                chunk_docs=chunk, dtype="float32", use_pallas=use))
            for name, use in (("kernel", True), ("xla", False))}
    times = {"kernel": [], "xla": []}
    for arm in ab_order(reps):
        step, data, warm, _ = arms[arm]
        times[arm] += timed_chains(step, data, warm, iters, 1,
                                   lambda s: float(jnp.sum(s.alpha)))
    med = {k: statistics.median(v) for k, v in times.items()}
    bodies = lda_mod.estep_bodies(arms["kernel"][3], K)
    return {
        "metric": f"lda_k{K}_nsf_docs_per_sec_kernel_vs_xla",
        "kernel_docs_per_s": packed.M * iters / med["kernel"],
        "xla_docs_per_s": packed.M * iters / med["xla"],
        "speedup": med["xla"] / med["kernel"],
        "chain_s": times, "iters_per_chain": iters,
        "kernel_rows": sum(r for _, r, b in bodies if b == "kernel"),
        "xla_rows": sum(r for _, r, b in bodies if b == "xla"),
        **device_fields(),
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from topicmodelsvb_jl_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    if "--estep-ab" in argv:
        print(json.dumps(run_estep_ab()))
        return
    if "--sweep-dist" in argv:
        for skew in (1.5, 3.0, 5.0):
            print(json.dumps(run_lda(skew=skew)))
        return
    print(json.dumps(run_lda()))


if __name__ == "__main__":
    main()
