"""The f32 training-noise lever of the per-doc digamma channel, measured.

The residual f32 training wobble at the tol=1.0 stop comes from the
per-doc gamma → Elogtheta digamma channel.  ``RuntimeConfig.elogtheta_f64``
promotes exactly that [B, K] channel to f64 with f32 cast-back
(models/lda.py); this script measures the A/B: planted-topic corpus at
NSF scale, tol=1.0, checkelbo=1, 400-iteration ceiling, on the card.
Reported per arm:

  * stop iteration (where the reference's tol=1.0 early stop fires)
  * first negative ∆elbo (iteration + magnitude — the noise firing)
  * tail RMS of ∆elbo over the last 50 pre-stop iterations

Usage:  python bench_f64_channel.py            (full NSF planted scale)
        BENCH_M=16384 python bench_f64_channel.py   (smaller planted run)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

jax.config.update("jax_enable_x64", True)   # the knob requires x64

import numpy as np

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig

M = int(os.environ.get("BENCH_M", 128_804))
V = int(os.environ.get("BENCH_V", 25_319))
K = int(os.environ.get("BENCH_K", 100))
ITERS = int(os.environ.get("BENCH_ITERS", 400))

t0 = time.perf_counter()
corp = tm.synth_corpus(M=M, V=V, K=K, seed=7, mean_tokens=130,
                       mean_terms=85)
print(f"# corpus built in {time.perf_counter() - t0:.1f}s", flush=True)

for knob in (False, True):
    m = tm.LDA(corp, K, seed=7,
               runtime=RuntimeConfig(elogtheta_f64=knob,
                                     # same body both arms: the knob
                                     # forces XLA; match the baseline
                                     use_pallas=False))
    t0 = time.perf_counter()
    m.train(iter=ITERS, tol=1.0, checkelbo=1, printelbo=False)
    wall = time.perf_counter() - t0
    deltas = [(r.k, r.delta_elbo) for r in m.trainer.trace
              if r.delta_elbo is not None]
    ks = [k for k, _ in deltas]
    ds = np.array([d for _, d in deltas])
    stop_k = ks[-1]
    neg = [(k, d) for k, d in deltas if d < 0]
    tail = ds[-min(50, len(ds)):]
    print(json.dumps(dict(
        elogtheta_f64=knob, M=M, V=V, K=K,
        stop_iteration=stop_k,
        iterations_run=len(ks),
        hit_iter_ceiling=stop_k >= ITERS,
        first_negative=(dict(k=neg[0][0], delta=float(neg[0][1]))
                        if neg else None),
        n_negative=len(neg),
        tail_rms_delta=float(np.sqrt(np.mean(tail ** 2))),
        last_delta=float(ds[-1]),
        final_elbo=float(m.elbo),
        wall_s=round(wall, 1),
        s_per_iter=round(wall / max(len(ks), 1), 3),
    )), flush=True)
