#!/usr/bin/env python
"""CTM benchmark: steady outer-iteration wall-clock at NSF scale, K=50.

Reference baseline: gpuCTM 10 iterations on NSF at K=50 in 276 s
(plots.R:4) => 27.6 s/iteration on an Apple-M1 OpenCL GPU.

Same harness discipline as bench.py: public api path, timed chains
restarting from one warmed state, median of BENCH_REPS chains, value-
fetch syncs.  Equivalent one-command run:

    python -m topicmodelsvb_jl_tpu.train --model ctm --corpus nsf-scale \\
        --k 50 --iter 3 --checkelbo inf --json

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} where
value is seconds per outer iteration (lower is better) and vs_baseline
is the speedup factor over 27.6 s.
"""

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench import make_packed_nsf_scale, timed_chains  # noqa: E402


def run_ctm(reps=None):
    import jax
    import jax.numpy as jnp

    from topicmodelsvb_jl_tpu.api import CTM
    from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig, TrainConfig

    K = int(os.environ.get("BENCH_K", 50))
    iters = int(os.environ.get("BENCH_ITERS", 3))
    chunk = int(os.environ.get("BENCH_CHUNK", 2048))  # api's CTM default
    M = int(os.environ.get("BENCH_M", 128_804))
    if reps is None:
        reps = int(os.environ.get("BENCH_REPS", 3))

    packed = make_packed_nsf_scale(M=M, chunk_docs=chunk)
    rt = RuntimeConfig(chunk_docs=chunk, dtype="float32")
    model = CTM(packed, K, runtime=rt, seed=7)

    cfg = TrainConfig(iter=iters, checkelbo=float("inf")).resolved(K)
    model._cfg = cfg
    tr = model._build_trainer(cfg)
    state = jax.device_put(model.state, tr.state_sharding)

    warm = tr.step_fn(state, *tr.data)
    float(jnp.sum(warm.mu))

    times = timed_chains(tr.step_fn, tr.data, warm, iters, reps,
                         lambda s: float(jnp.sum(s.mu)))
    best = statistics.median(times)

    s_per_iter = best / iters
    baseline = 27.6  # reference gpuCTM NSF K=50 (plots.R:4)
    return {
        "metric": f"ctm_k{K}_nsf_s_per_iter",
        "value": round(s_per_iter, 3),
        "unit": "s/iter",
        "vs_baseline": round(baseline / s_per_iter, 3),
    }


if __name__ == "__main__":
    print(json.dumps(run_ctm()))
