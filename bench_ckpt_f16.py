"""On-card async-checkpoint byte/impact measurement.

The async writer's cost on a training step is set by the device-to-host
bytes of each snapshot; RuntimeConfig.checkpoint_f16 halves them by
snapshotting the per-doc leaves at f16.  This bench measures, on the
card:

  1. snapshot bytes, f32 vs f16 (the per-doc mass is the target);
  2. the D2H fetch wall-time for one snapshot, f32 vs f16;
  3. steady step time with checkpoint_every=1 async checkpointing,
     off / f32 / f16.

Usage: python bench_ckpt_f16.py [--m M] [--iters N]
Prints one JSON line per measurement.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=128_804)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (JAX_PLATFORMS is "
                         "pinned by some images; env alone won't do)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu import checkpoint as ckptlib
    from topicmodelsvb_jl_tpu.datasets import synth_packed_nsf_scale

    packed = synth_packed_nsf_scale(M=args.m, chunk_docs=1024)
    rt = dict(chunk_docs=1024)

    def build():
        m = tm.LDA(packed, args.k, seed=7, runtime=tm.RuntimeConfig(**rt))
        m.train(iter=1, tol=0.0, checkelbo=np.inf, printelbo=False)  # warm
        return m

    m = build()

    # 1+2: snapshot bytes and fetch wall-time per mode
    for mode in (None, "f16"):
        snap = ckptlib.snapshot(m, compress=mode)
        t0 = time.perf_counter()
        total = doc = 0
        for name in snap[1]._fields:
            a = np.asarray(getattr(snap[1], name))   # the D2H fetch
            total += a.nbytes
            if name in snap[2]:
                doc += a.nbytes
        fetch_s = time.perf_counter() - t0
        print(json.dumps(dict(
            measure="snapshot", mode=mode or "f32",
            total_MB=round(total / 1e6, 1), per_doc_MB=round(doc / 1e6, 1),
            fetch_s=round(fetch_s, 3),
            fetch_MBps=round(total / 1e6 / fetch_s, 1))), flush=True)

    # 3: steady step time with checkpoint_every=1, off/f32/f16
    for label, ck in (("off", {}),
                      ("f32", dict(checkpoint_every=1)),
                      ("f16", dict(checkpoint_every=1,
                                   checkpoint_f16=True))):
        d = tempfile.mkdtemp(prefix="tmvb_ckb_") if ck else None
        if ck:
            ck = dict(ck, checkpoint_dir=d)
        mm = tm.LDA(packed, args.k, seed=7,
                    runtime=tm.RuntimeConfig(**rt, **ck))
        mm.train(iter=1, tol=0.0, checkelbo=np.inf, printelbo=False)
        t0 = time.perf_counter()
        mm.train(iter=args.iters, tol=0.0, checkelbo=np.inf,
                 printelbo=False)
        if mm._ckpt_writer is not None:
            mm._ckpt_writer.wait()
        dt = (time.perf_counter() - t0) / args.iters
        print(json.dumps(dict(
            measure="step", ckpt=label, step_s=round(dt, 4))), flush=True)
        if d:
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
