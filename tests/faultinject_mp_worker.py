"""Worker for the MULTI-PROCESS SIGKILL fault-injection test (SURVEY
§5.3's "kill-a-host" bar).

Two modes:

* ``train`` — joins the jax.distributed mesh and trains LDA with the
  auto-checkpoint cadence; every process writes its addressable shards
  (checkpoint.py directory format) and the parent SIGKILLs all
  processes mid-run.
* ``resume <total_iters>`` — joins a fresh mesh, loads the last
  complete checkpoint directory, trains the remaining iterations, and
  prints the ELBO trace as one JSON line.

Usage: python faultinject_mp_worker.py <proc_id> <nproc> <port>
           <ckpt_dir> train|resume [total_iters]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

proc_id, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
ckpt_dir = sys.argv[4]
mode = sys.argv[5]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from topicmodelsvb_jl_tpu.parallel import multihost  # noqa: E402

multihost.initialize(f"localhost:{port}", nproc, proc_id)
assert jax.process_count() == nproc, jax.process_count()

import numpy as np  # noqa: E402

import topicmodelsvb_jl_tpu as tm  # noqa: E402
from topicmodelsvb_jl_tpu import checkpoint as ckptlib  # noqa: E402
from topicmodelsvb_jl_tpu.api import LDA  # noqa: E402
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig  # noqa: E402

corp = tm.synth_corpus(M=64, V=40, K=3, seed=21)

if mode == "train":
    rt = RuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8,
                       checkpoint_every=2, checkpoint_dir=ckpt_dir)
    model = LDA(corp, 3, runtime=rt, seed=9)
    # tol=0 with f64 monotone ELBO never early-stops; the parent SIGKILLs
    # all processes long before 100000 iterations
    model.train(iter=100_000, tol=0.0, checkelbo=1, printelbo=False)
else:
    total = int(sys.argv[6])
    done = sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("ckpt_iter") and not d.endswith(".tmp"))
    last = done[-1]
    k_ckpt = int(last.replace("ckpt_iter", ""))
    model = ckptlib.load(os.path.join(ckpt_dir, last), corp)
    model.train(iter=total - k_ckpt, tol=0.0, checkelbo=1, printelbo=False)
    trace = [r.elbo for r in model.trainer.trace if r.elbo is not None]
    print(json.dumps({
        "proc": proc_id,
        "k_ckpt": k_ckpt,
        "elbo": trace,
        "beta": np.asarray(model.beta).tolist(),
    }), flush=True)
