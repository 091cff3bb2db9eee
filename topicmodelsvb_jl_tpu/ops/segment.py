"""Segment reductions for the sufficient statistics.

The reference makes its OpenCL scatter-adds race-free with a
precomputed inverted index — one work-item per vocab word walking a
sorted token permutation (``terms_sortperm``/``J_cumsum`` built at
modelutils.jl:371-397, consumed at gpuLDA.jl:170-175).  Under XLA the
same reduction is a ``segment_sum`` over vocab ids.

Determinism: on the CPU backend the scatter applies one update at a
time in a fixed order, so same-seed runs produce bitwise identical
sufficient statistics (tests/test_lda.py::test_lda_deterministic).  On
a GPU, XLA lowers the scatter-add to atomics whose order changes from
run to run: same-seed results agree to f32 rounding of each row sum
(relative ~1e-6 per statistic), not bitwise, and the per-document
fixpoint can carry that rounding into the trajectory at the level the
multi-device checks state (chip_smoke.py, __graft_entry__.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def count_scatter(weights: jax.Array, ids: jax.Array, num_segments: int) -> jax.Array:
    """Σ over tokens of ``weights[token, :]`` into rows by ``ids[token]``.

    weights: [T, K] per-token rows; ids: [T] int32 segment ids (0-based).
    Returns [num_segments, K].  This is the XLA form of the
    reference's ``beta_temp[:, terms] += phi .* counts'`` (LDA.jl:129-132)
    and the alef/he/kappa analogues.
    """
    return jax.ops.segment_sum(
        weights, ids, num_segments=num_segments,
        indices_are_sorted=False, unique_indices=False,
    )


def count_scatter_into(acc: jax.Array, weights: jax.Array,
                       ids: jax.Array) -> jax.Array:
    """Scatter-add ``weights`` rows into ``acc`` by ``ids`` — in place.

    Same reduction as ``acc + count_scatter(w, ids, V)`` but lowered as
    ONE scatter-add onto the scan carry, which XLA aliases in place:
    the zero-init of a fresh [V, K] segment target and the full [V, K]
    read+write of the elementwise add disappear.  Per outer iteration
    that removes O(n_chunks · V · K) device-memory traffic — at V=2e6,
    K=100, 32 chunks that is ~77 GB/iter of pure accumulator traffic,
    the large-V step cost.  Determinism is that of ``segment_sum``
    (the module docstring): bitwise on the CPU, rounding-level on a GPU.
    """
    return acc.at[ids].add(weights, indices_are_sorted=False,
                           unique_indices=False)
