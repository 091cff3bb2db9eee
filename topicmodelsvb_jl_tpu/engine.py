"""CAVI training driver.

Re-implements the reference's ``train!`` control flow (LDA.jl:161-191 and
per-model twins) around jitted, shard_map'd step functions:

* outer loop in Python, one jitted device step per coordinate-ascent
  iteration (the whole E-sweep + M-step + hyperparameter Newton is a
  single compiled program — nothing leaves the device between
  iterations);
* ``check_elbo`` cadence, ∆elbo print format, and early stopping mirror
  ``check_elbo!`` (modelutils.jl:574-585).  Unlike the reference — which
  recomputes ELBO on the *host*, making frequent checks expensive
  (README.md:686-688) — the ELBO here is a second jitted device program,
  so ``checkelbo=1`` is cheap;
* structured per-iteration metrics (elbo, ∆elbo, docs/sec, step time)
  are collected into a trace for the benchmark harness.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional

import jax
import numpy as np

from .utils.config import TrainConfig
from .utils.numerics import elbo_value


@dataclasses.dataclass
class IterationRecord:
    k: int
    step_time_s: float
    docs_per_s: float
    tokens_per_s: float = 0.0
    elbo: Optional[float] = None
    delta_elbo: Optional[float] = None
    host_sync_s: Optional[float] = None
    # steps dispatch asynchronously, so wall time is only observable at
    # sync points: step_time_s/docs_per_s/tokens_per_s are the AVERAGE
    # over the `span` iterations ending at this row's sync (span=1 means
    # true per-iteration resolution, e.g. under checkelbo=1)
    span: int = 1


class Trainer:
    """Generic CAVI driver over a model's jitted (step, elbo) pair.

    ``step_fn(state, *data) -> state`` runs one full outer iteration;
    ``elbo_fn(state, *elbo_data) -> scalar`` evaluates the bound with the
    reference's exact *_old semantics.  Data is positional because the
    shard_map in_specs are positional.
    """

    def __init__(
        self,
        step_fn: Callable,
        elbo_fn: Callable,
        data: tuple,
        elbo_data: Optional[tuple] = None,
        M: int = 0,
        C: int = 0,
        flops_per_step: float = 0.0,
        printer: Callable[[str], None] = print,
        metrics_path: Optional[str] = None,
        profile_dir: Optional[str] = None,
        profile_steps: int = 3,
        state_sharding=None,
        checkpoint_cb: Optional[Callable] = None,
        checkpoint_every: int = 0,
    ):
        self.step_fn = step_fn
        self.elbo_fn = elbo_fn
        self.data = tuple(data)
        self.elbo_data = tuple(elbo_data) if elbo_data is not None else self.data
        self.M = M
        # corpus token count (reference: model.C, LDA.jl:31) → tokens/sec;
        # flops_per_step (an arithmetic estimate) → TFLOP/s
        self.C = C
        self.flops_per_step = flops_per_step
        self.printer = printer
        self.trace: List[IterationRecord] = []
        # observability (SURVEY §5.1/§5.5): JSONL per-iteration metrics
        # and an optional jax.profiler capture of the first steady steps
        self.metrics_path = metrics_path
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        # placing the initial state with the step's output shardings up
        # front avoids a silent second compile on iteration 2 (the first
        # step's outputs otherwise change the arg shardings)
        self.state_sharding = state_sharding
        # §5.3 recovery story: checkpoint_cb(k, state) every
        # checkpoint_every outer iterations (0 disables)
        self.checkpoint_cb = checkpoint_cb
        self.checkpoint_every = int(checkpoint_every)

    def train(self, state, cfg: TrainConfig, corpus_all_empty: bool = False,
              start_iter: int = 0):
        """Run ``cfg.iter`` outer iterations, numbering them globally
        from ``start_iter + 1`` — a resumed run continues the iteration
        counter (JSONL rows and checkpoint filenames never collide
        across a resume)."""
        cfg.validate()
        if self.state_sharding is not None:
            if jax.process_count() > 1:
                from .parallel.multihost import make_global_state

                state = make_global_state(state, self.state_sharding)
            else:
                state = jax.device_put(state, self.state_sharding)
        n_iter = 0 if corpus_all_empty else cfg.iter

        # initial bound (reference: `(checkelbo <= iter) && update_elbo!(model)`)
        if cfg.checkelbo <= n_iter:
            e0 = self.elbo_fn(state, *self.elbo_data)
            state = state._replace(elbo=e0)

        profiling = False
        # Steps are dispatched asynchronously (good for throughput: the
        # host never blocks the device between iterations).  Wall time is
        # only meaningful at synchronisation points — the ELBO checks,
        # whose float() fetch cannot return early — so per-iteration
        # step_time_s is back-filled as the average over each sync span.
        span_start = time.perf_counter()
        span_recs = []
        k0 = int(start_iter)
        for k in range(k0 + 1, k0 + n_iter + 1):
            if self.profile_dir and k == k0 + 2:  # skip the compile iteration
                jax.profiler.start_trace(self.profile_dir)
                profiling = True
            with jax.profiler.StepTraceAnnotation("cavi_step", step_num=k):
                state = self.step_fn(state, *self.data)
            if profiling and k >= k0 + 1 + self.profile_steps:
                jax.block_until_ready(jax.tree_util.tree_leaves(state))
                jax.profiler.stop_trace()
                profiling = False
            rec = IterationRecord(k=k, step_time_s=0.0, docs_per_s=0.0)
            span_recs.append(rec)

            # check_elbo! (modelutils.jl:574-585)
            sync = cfg.checkelbo != float("inf") and k % int(cfg.checkelbo) == 0
            if sync or k == k0 + n_iter:
                if sync:
                    new_elbo = self.elbo_fn(state, *self.elbo_data)
                    sync_t0 = time.perf_counter()
                    # the bound is a compensated (hi, lo) pair; combine
                    # in f64 on the host so ∆elbo keeps sub-ulp(total)
                    # resolution (fetch = real sync)
                    new_val = elbo_value(new_elbo)
                    delta = new_val - elbo_value(state.elbo)
                    sync_wait = time.perf_counter() - sync_t0
                    state = state._replace(elbo=new_elbo)
                    # assign before the span backfill below so the JSONL
                    # row for this iteration carries elbo/∆elbo too
                    rec.elbo, rec.delta_elbo = new_val, delta
                    rec.host_sync_s = sync_wait
                    if cfg.printelbo:
                        self.printer(f"{k} ∆elbo: {round(delta, 3)}")
                else:
                    # checkelbo=inf: best-effort sync for the final span
                    sync_t0 = time.perf_counter()
                    jax.block_until_ready(jax.tree_util.tree_leaves(state))
                    rec.host_sync_s = time.perf_counter() - sync_t0
                span = time.perf_counter() - span_start
                per = span / len(span_recs)
                for r in span_recs:
                    r.span = len(span_recs)
                    r.step_time_s = per
                    r.docs_per_s = self.M / max(per, 1e-12)
                    r.tokens_per_s = self.C / max(per, 1e-12)
                    self._emit(r)   # emit only once timings are real
                span_recs = []
                span_start = time.perf_counter()
            self.trace.append(rec)
            if (self.checkpoint_cb is not None and self.checkpoint_every > 0
                    and k % self.checkpoint_every == 0):
                # checkpoint wall time (state fetch + hash + disk write)
                # must not count toward the back-filled step timings
                cb_t0 = time.perf_counter()
                self.checkpoint_cb(k, state)
                span_start += time.perf_counter() - cb_t0
            if rec.delta_elbo is not None and rec.delta_elbo < cfg.tol:
                break

        if profiling:
            jax.profiler.stop_trace()
        return state

    def _emit(self, rec: IterationRecord) -> None:
        if not self.metrics_path:
            return
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(dataclasses.asdict(rec)) + "\n")

    def summary(self) -> Dict[str, float]:
        if not self.trace:
            return {}
        times = np.array([r.step_time_s for r in self.trace])
        steady = times[1:] if len(times) > 1 else times  # drop compile iter
        mean_step = float(steady.mean()) if steady.size else 0.0
        syncs = [r.host_sync_s for r in self.trace if r.host_sync_s is not None]
        out = {
            "iterations": len(self.trace),
            "mean_step_s": mean_step,
            "docs_per_s": float(self.M / mean_step) if mean_step else 0.0,
            "tokens_per_s": float(self.C / mean_step) if mean_step else 0.0,
            "host_sync_s_total": float(np.sum(syncs)) if syncs else 0.0,
            "total_s": float(times.sum()),
            "final_elbo": next(
                (r.elbo for r in reversed(self.trace) if r.elbo is not None), None
            ),
        }
        if self.flops_per_step and mean_step:
            out["flops_per_step"] = self.flops_per_step
            out["tflops_per_s"] = self.flops_per_step / mean_step / 1e12
        return out
