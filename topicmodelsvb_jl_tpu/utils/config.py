"""Configuration dataclasses.

The reference has no config system — everything is keyword arguments on
``train!`` with model-aware defaults (LDA.jl:161, CTPF.jl:344) plus fixed
constructor initialisations.  Here those knobs become two dataclasses:

* :class:`TrainConfig` mirrors the reference ``train!`` kwargs, with the
  same names and defaults (``iter=150, tol=1.0, niter=1000, ntol=1/K²,
  viter=10, vtol=1/K², checkelbo=1, printelbo=True``).
* :class:`RuntimeConfig` holds the execution knobs that have no
  reference counterpart: doc-chunk size, padding multiple, dtype policy,
  mesh shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors reference ``train!`` kwargs (LDA.jl:161)."""

    iter: int = 150
    tol: float = 1.0
    niter: int = 1000
    ntol: Optional[float] = None   # default 1/K² resolved at train time
    viter: int = 10
    vtol: Optional[float] = None   # default 1/K² resolved at train time
    checkelbo: float = 1           # positive int or float('inf')
    printelbo: bool = True

    def resolved(self, K: int) -> "TrainConfig":
        return dataclasses.replace(
            self,
            ntol=self.ntol if self.ntol is not None else 1.0 / K**2,
            vtol=self.vtol if self.vtol is not None else 1.0 / K**2,
        )

    def validate(self) -> None:
        if not all(t >= 0 for t in (self.tol, self.ntol or 0, self.vtol or 0)):
            raise ValueError("tolerance parameters must be nonnegative.")
        if not all(i >= 0 for i in (self.iter, self.niter, self.viter)):
            raise ValueError("iteration parameters must be nonnegative.")
        ok = (self.checkelbo == float("inf")) or (
            float(self.checkelbo).is_integer() and self.checkelbo > 0
        )
        if not ok:
            raise ValueError("checkelbo parameter must be a positive integer or Inf.")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs (no reference counterpart).

    The defaults of ``chunk_docs`` (and the CTM/fCTM 2048 in api.py),
    ``pad_multiple`` and ``bucket_pad`` were tuned on earlier hardware
    and are not yet measured on the H100 (PERF.md lists them).
    """

    # docs per E-step chunk (bounds the [B, L, K] device-memory use);
    # the Newton-heavy CTM/fCTM default to 2048 (api._preferred_chunk)
    # to amortize their per-chunk while-loop latency over more documents
    chunk_docs: int = 1024
    pad_multiple: int = 64        # token-axis padding multiple
    # per-segment token-width multiple under bucketed packing: every
    # padded token slot costs full gather + E-step + scatter row work,
    # so the multiple is kept small (the fused E-step kernel needs 8)
    bucket_pad: int = 8
    dtype: str = "float32"        # compute dtype; "float64" for the CPU oracle
    data_axis: str = "data"       # mesh axis docs are sharded over
    vocab_axis: str = "vocab"     # mesh axis beta may be sharded over (TP)
    mesh_shape: Optional[tuple] = None  # None → all devices on data axis
    # fused LDA E-step kernel: True = automatic choice (GPU backend,
    # K >= 64, segment fits; kernels/lda_estep.choose_estep), False =
    # force the pure-XLA body everywhere
    use_pallas: bool = True
    # evaluate the per-doc gamma → Elogtheta digamma channel in f64 with
    # f32 cast-back (the token-level [B, L, K] math stays f32).  This
    # channel carries the residual f32 training noise that fires the
    # tol=1.0 stop (bench_f64_channel.py measures it); an accuracy knob,
    # not a default.  Requires jax_enable_x64 (checked at model build);
    # forces the XLA E-step body (the kernel's digamma series is f32).
    elogtheta_f64: bool = False
    metrics_path: Optional[str] = None  # JSONL per-iteration metrics sink
    profile_dir: Optional[str] = None   # jax.profiler capture directory
    profile_steps: int = 3              # steady steps to capture
    # checkpoint-every-N-outer-iterations during train(); 0 disables.
    # Files go to checkpoint_dir/ckpt_iter{k}. (SURVEY §5.3 recovery story.)
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    # cast the per-doc state leaves (the snapshot's dominant bytes) to
    # f16 on device before the async checkpoint's D2H fetch — halves
    # the transfer the writer must hide on slow host links.  Opt-in:
    # a resume from an f16 snapshot re-converges rather than
    # bit-reproducing the trace (checkpoint.snapshot docstring).
    checkpoint_f16: bool = False
