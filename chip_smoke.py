#!/usr/bin/env python
"""On-card smoke run: every model family's main path on one NVIDIA GPU.

    python chip_smoke.py              # one card: phases 0-3
    python chip_smoke.py --cards 4    # four cards: the multi-device path only

Phases, in one process (a JAX process reserves most of a card's memory,
so a second one could not share it):

0. Device: the JAX platform must be ``gpu`` (no CPU fallback); the card's
   name and power limit from ``nvidia-smi``; the JAX version and the
   compile-cache directory.
1. LDA K=100 at NSF scale (128,804 docs, V=25,319) through the CLI entry
   point ``train.main`` and then through ``api.LDA(...).train``, both on
   the default RuntimeConfig, so the automatic E-step choice is what
   runs.  Prints which body ran on each bucketed segment.
2. fLDA, CTM, fCTM, CTPF, DTM and HMTM at their bench shapes, three
   iterations each through ``api``.
3. The fused LDA E-step kernel against the XLA body at NSF K=100 on two
   segment widths, and the XLA LDA step against the f64 oracle.

Each phase prints one JSON line.  Every family is held to the same
invariants: every ELBO finite, ``validate.check_model`` passes, and
``topicdist`` rows sum to 1.  A failed phase stops the run with a
non-zero exit.  The last line is ``{"ok": true, "device": {...}}``.
Step times printed here come from a smoke run (few iterations, first
one compiling); they are not a benchmark.

The phase functions take their sizes as arguments, so the CPU tests run
them at tiny sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

NSF_M, NSF_V = 128_804, 25_319

# family → (K, corpus source, docs) at the bench shapes
FAMILIES = {
    "lda": (100, "nsf", NSF_M),
    "flda": (100, "nsf", NSF_M),
    "ctm": (50, "nsf", NSF_M),
    "fctm": (50, "nsf", NSF_M),
    "ctpf": (100, "citeu", 16_980),
    "dtm": (20, "mac", 75_011),
    "hmtm": (25, "nsf", NSF_M),
}

# Kernel-vs-XLA tolerance on beta after two steps: two f32 fixpoints that
# order their sums differently drift apart through the viter iterations
# and the per-doc convergence breaks (same bound as tests/test_kernels.py).
PARITY_RTOL, PARITY_ATOL = 5e-3, 1e-5


def emit(phase: str, **fields) -> dict:
    line = {"phase": phase, **fields}
    print(json.dumps(line), flush=True)
    return line


def gpu_name_and_power() -> str:
    """``name, power.limit`` of the first card, read without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device(cards: int = 1) -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{devs[0].platform!r}); nothing was run")
    if len(devs) < cards:
        raise SystemExit(f"chip_smoke: {cards} cards asked, "
                         f"{len(devs)} found")
    from topicmodelsvb_jl_tpu.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    card = gpu_name_and_power()
    print(card, flush=True)
    return emit("device", platform=devs[0].platform,
                kind=devs[0].device_kind, count=len(devs), card=card,
                jax=jax.__version__, compile_cache=cache)


# ── shared checks ──────────────────────────────────────────────────────

def check_trained(model, iters: int) -> dict:
    """Every ELBO finite, check_model passes, topicdist rows sum to 1."""
    import numpy as np

    from topicmodelsvb_jl_tpu.validate import check_model

    trace = model.trainer.trace
    elbos = [r.elbo for r in trace if r.elbo is not None]
    if len(trace) != iters or len(elbos) != iters:
        raise AssertionError(f"{len(trace)} iterations / {len(elbos)} "
                             f"ELBOs, expected {iters}")
    if not all(math.isfinite(e) for e in elbos):
        raise AssertionError(f"non-finite ELBO in {elbos}")
    check_model(model)
    td = np.asarray(model.topicdist(np.arange(1, model.M + 1)), np.float64)
    if td.shape != (model.M, model.K) or not np.all(np.isfinite(td)):
        raise AssertionError(f"topicdist shape {td.shape} or non-finite")
    row_err = float(np.max(np.abs(td.sum(axis=1) - 1.0)))
    if row_err > 1e-4:
        raise AssertionError(f"topicdist rows off 1 by {row_err}")
    return dict(elbos=elbos, topicdist_row_err=row_err,
                step_s=[r.step_time_s for r in trace])


def build_model(family: str, K: int, M: int, V: int = None, seed: int = 7,
                mesh=None):
    """The family's api model on its bench corpus at ``M`` docs, with the
    default RuntimeConfig (``V`` shrinks the NSF-shaped vocabulary for
    tiny CPU runs)."""
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu import datasets
    from topicmodelsvb_jl_tpu.ops.packing import unit_counts

    cls = {"lda": tm.LDA, "flda": tm.fLDA, "ctm": tm.CTM, "fctm": tm.fCTM,
           "ctpf": tm.CTPF, "dtm": tm.DTM, "hmtm": tm.HMTM}[family]
    source = FAMILIES[family][1]
    with warnings.catch_warnings():
        # the loaders warn that they synthesize at the published scale
        warnings.simplefilter("ignore")
        if source == "nsf":
            corp = datasets.synth_packed_nsf_scale(
                M=M, V=V or NSF_V, seed=seed,
                chunk_docs=cls._preferred_chunk)
            if family == "hmtm":   # an ordered token stream: counts of 1
                corp = unit_counts(corp)
        elif source == "citeu":
            corp = datasets.load_citeu(seed=seed, subset=M)
        else:
            corp = datasets.load_mac(seed=seed, subset=M)
    if family == "dtm":
        return cls(corp, K, delta=1.0, seed=seed, mesh=mesh)
    return cls(corp, K, seed=seed, mesh=mesh)


# ── phase 1: LDA through the CLI and the api ──────────────────────────

def phase_lda(M: int = NSF_M, K: int = 100, cli_iter: int = 3,
              api_iter: int = 5) -> dict:
    from topicmodelsvb_jl_tpu import train
    from topicmodelsvb_jl_tpu.models import lda as lda_mod

    argv = ["--model", "lda", "--corpus", "nsf-scale", "--subset", str(M),
            "--k", str(K), "--iter", str(cli_iter), "--checkelbo", "1",
            "--json"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    cli_s = time.perf_counter() - t0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or summary.get("iterations") != cli_iter \
            or not math.isfinite(summary.get("final_elbo") or math.nan):
        raise AssertionError(f"train.main rc={rc} summary={summary}")

    t0 = time.perf_counter()
    model = build_model("lda", K, M)
    model.train(iter=api_iter, checkelbo=1, printelbo=False)
    api_s = time.perf_counter() - t0
    checks = check_trained(model, api_iter)
    bodies = lda_mod.estep_bodies(model.packed, K)
    return emit("lda", K=K, M=M, cli_final_elbo=summary["final_elbo"],
                cli_wall_s=cli_s, api_wall_s=api_s,
                estep_bodies=[dict(width=w, rows=r, body=b)
                              for w, r, b in bodies],
                timing="smoke run, not a benchmark", **checks)


# ── phase 2: the other six families ────────────────────────────────────

def phase_family(family: str, M: int = None, K: int = None, V: int = None,
                 iters: int = 3) -> dict:
    K0, _, M0 = FAMILIES[family]
    K, M = K or K0, M or M0
    t0 = time.perf_counter()
    model = build_model(family, K, M, V=V)
    t1 = time.perf_counter()
    model.train(iter=iters, checkelbo=1, printelbo=False)
    t2 = time.perf_counter()
    checks = check_trained(model, iters)
    return emit(family, K=K, M=M, build_s=t1 - t0, train_s=t2 - t1,
                timing="smoke run, not a benchmark", **checks)


# ── phase 3: kernel parity and the f64 oracle ─────────────────────────

def dense_packed(M: int, V: int, L: int, seed: int = 0):
    """NSF-shaped dense corpus with token width ``L``: Zipf-skewed term
    ids (as datasets.synth_packed_nsf_scale) and lengths in [L/2, L]."""
    import numpy as np

    from topicmodelsvb_jl_tpu.ops.packing import PackedCorpus

    rng = np.random.default_rng(seed)
    N = rng.integers(L // 2, L + 1, size=M).astype(np.int32)
    valid = np.arange(L)[None, :] < N[:, None]
    u = rng.random((M, L), dtype=np.float32)
    terms = (np.minimum((V * u**3).astype(np.int32), V - 1) * valid)
    counts = ((1 + rng.poisson(0.35, size=(M, L))) * valid).astype(np.float32)
    return PackedCorpus(
        terms=terms.astype(np.int32), counts=counts,
        doc_mask=np.ones(M, np.float32), N=N, C=counts.sum(1), M=M, V=V,
        L=L, max_count=int(counts.max()))


def widest_kernel_width(K: int) -> int:
    from topicmodelsvb_jl_tpu.kernels.lda_estep import fits, padded_topics

    L = 8
    while fits(L + 8, padded_topics(K)):
        L += 8
    return L


def phase_kernel_parity(M: int = 4096, V: int = NSF_V, K: int = 100,
                        widths=None, steps: int = 2) -> dict:
    """The fused kernel and the XLA body from the same state, two steps,
    both at HIGHEST matmul precision; beta compared at PARITY_RTOL/ATOL."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from topicmodelsvb_jl_tpu.kernels.lda_estep import choose_estep
    from topicmodelsvb_jl_tpu.models import lda as lda_mod

    backend = jax.default_backend()
    widths = widths or (88, widest_kernel_width(K))
    results = []
    for L in widths:
        if not choose_estep(K, L, backend=backend, use_pallas=True):
            raise AssertionError(f"kernel gate refuses width {L} at K={K}")
        packed = dense_packed(M, V, L)
        data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
                jnp.asarray(packed.doc_mask),
                jnp.asarray(float(packed.M), jnp.float32))
        kw = dict(viter=10, vtol=1.0 / K**2, niter=1000, ntol=1.0 / K**2,
                  chunk_docs=min(1024, M), axis_name=None)
        state0 = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float32)
        out, secs = {}, {}
        for name, use in (("xla", False), ("kernel", True)):
            with jax.default_matmul_precision("highest"):
                step = jax.jit(lda_mod.make_step(
                    packed, K, use_pallas=use,
                    # the CPU tests interpret the kernel; the card compiles it
                    pallas_interpret=use and backend != "gpu", **kw))
                s = jax.block_until_ready(step(state0, *data))
                t0 = time.perf_counter()
                for _ in range(steps - 1):
                    s = step(s, *data)
                out[name] = np.asarray(s.beta)
                secs[name] = (time.perf_counter() - t0) / max(steps - 1, 1)
        bx, bk = out["xla"], out["kernel"]
        dev = float(np.max(np.abs(bx - bk) / (PARITY_ATOL
                                              + PARITY_RTOL * np.abs(bx))))
        results.append(dict(width=L, dev_over_tol=dev,
                            step_s_xla=secs["xla"],
                            step_s_kernel=secs["kernel"]))
        if not dev <= 1.0:
            raise AssertionError(f"kernel vs XLA at width {L}: beta off by "
                                 f"{dev:.3g}x the tolerance")
    return emit("kernel_parity", K=K, M=M, steps=steps,
                rtol=PARITY_RTOL, atol=PARITY_ATOL, widths=results,
                timing="smoke run, not a benchmark")


# XLA LDA step (f32, contractions at HIGHEST precision, so no TF32)
# against the f64 oracle after ORACLE_ITERS sweeps.  The f32 step tracks
# the oracle to ~5e-6 relative in beta and alpha and ~4e-7 in the ELBO
# on the CPU at these shapes; the bounds leave room for the GPU's own
# exp/log rounding and summation order (scatter atomics), and for a
# document whose ‖ΔElogtheta‖ lands within rounding of vtol and so
# stops one fixpoint pass apart in f32 and f64.
ORACLE_ITERS = 2
ORACLE_RTOL, ORACLE_ATOL = 2e-4, 1e-8        # beta; alpha uses the rtol
ORACLE_ELBO_RTOL = 1e-5


def phase_oracle(M: int = 2048, V: int = 5000, K: int = 100,
                 L: int = 128) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle import LDAOracle

    from topicmodelsvb_jl_tpu.models import lda as lda_mod
    from topicmodelsvb_jl_tpu.utils.numerics import elbo_value

    packed = dense_packed(M, V, L, seed=1)
    docs = [(packed.terms[d, :packed.N[d]], packed.counts[d, :packed.N[d]])
            for d in range(M)]
    state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float32)
    oracle = LDAOracle(docs, V=V, K=K,
                       beta0=np.asarray(state.beta, np.float64))
    want = oracle.train(ORACLE_ITERS)

    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask))
    chunk = min(1024, M)
    step = jax.jit(lda_mod.make_step(
        packed, K, viter=10, vtol=1.0 / K**2, niter=1000, ntol=1.0 / K**2,
        chunk_docs=chunk, axis_name=None, use_pallas=False))
    elbo = jax.jit(lda_mod.make_elbo(packed, K, chunk_docs=chunk))
    got = []
    for _ in range(ORACLE_ITERS):
        state = step(state, *data, jnp.asarray(float(M), jnp.float32))
        got.append(elbo_value(elbo(state, *data)))
    beta = np.asarray(state.beta, np.float64)
    beta_dev = float(np.max(np.abs(beta - oracle.beta)
                            / (ORACLE_ATOL + ORACLE_RTOL
                               * np.abs(oracle.beta))))
    alpha_rel = float(np.max(np.abs(np.asarray(state.alpha) - oracle.alpha)
                             / np.abs(oracle.alpha)))
    elbo_rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    line = emit("oracle", K=K, M=M, V=V, iters=ORACLE_ITERS,
                beta_dev_over_tol=beta_dev, alpha_rel=alpha_rel,
                elbo_rel=elbo_rel, rtol=ORACLE_RTOL, atol=ORACLE_ATOL,
                elbo_rtol=ORACLE_ELBO_RTOL)
    if not (beta_dev <= 1.0 and alpha_rel <= ORACLE_RTOL
            and elbo_rel <= ORACLE_ELBO_RTOL):
        raise AssertionError(f"XLA LDA step off the f64 oracle: {line}")
    return line


# ── four cards ─────────────────────────────────────────────────────────

# One card against four, same corpus and seed: the four-card run buckets
# its documents for four shards, so chunks hold other documents, and its
# sufficient statistics are sums in another order (XLA's GPU scatter-add
# and the cross-card psum are not bitwise reproducible).  Both move the
# f32 trajectory by rounding, which the fixpoint breaks can amplify.
MULTI_ELBO_RTOL = 1e-5


def phase_multi_card(n: int = 4, M: int = NSF_M, K: int = 100,
                     iters: int = 3) -> dict:
    import jax

    from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh

    sys.path.insert(0, ROOT)
    import __graft_entry__

    runs = {}
    for name, mesh in (("all", None), ("one", make_mesh(n_devices=1))):
        model = build_model("lda", K, M, mesh=mesh)
        model.train(iter=iters, checkelbo=1, printelbo=False)
        runs[name] = dict(devices=int(model.mesh.size),
                          **check_trained(model, iters))
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(runs["all"]["elbos"], runs["one"]["elbos"]))
    emit("lda_cards", K=K, M=M, cards=runs["all"]["devices"], elbo_rel=rel,
         elbo_rtol=MULTI_ELBO_RTOL, elbos_all=runs["all"]["elbos"],
         elbos_one=runs["one"]["elbos"],
         step_s_all=runs["all"]["step_s"], step_s_one=runs["one"]["step_s"],
         timing="smoke run, not a benchmark")
    # the dry run goes ahead even when the comparison above failed, so
    # one call reports both; the failure is raised after it
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        __graft_entry__.dryrun_multichip(n, real=True)
    line = emit("dryrun_multichip", cards=n,
                platform=jax.devices()[0].platform,
                result=buf.getvalue().strip())
    if runs["all"]["devices"] != n:
        raise AssertionError(f"default mesh spans {runs['all']['devices']} "
                             f"devices, expected {n}")
    if not rel <= MULTI_ELBO_RTOL:
        raise AssertionError(f"{n}-card ELBO trajectory off the one-card "
                             f"run by {rel:.3g} (limit {MULTI_ELBO_RTOL})")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card path and what it is "
                         "compared with")
    args = ap.parse_args(argv)

    dev = phase_device(args.cards)
    if args.cards == 1:
        phase_lda()
        for family in ("flda", "ctm", "fctm", "ctpf", "dtm", "hmtm"):
            phase_family(family)
        phase_kernel_parity()
        phase_oracle()
    else:
        phase_multi_card(args.cards)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
