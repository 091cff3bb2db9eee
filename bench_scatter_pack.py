"""Pack-time vocab-sorted layout against the doc-major production layout.

The last proposed lever against the LDA scatter floor (ROADMAP) was a
pack-time vocab-sorted chunk layout — the host-side analogue of the
reference's inverted index (modelutils.jl:371-397), whose sort cost is
paid once rather than per iteration.  The E-step is a two-table join
per token slot (beta by vocab id, Elogtheta by doc id); the production
doc-major layout gets the doc side for free (broadcast), so the sorted
layout can only win if sorted gathers/scatters beat random ones by ~2x.

Not yet measured on the H100 (ROADMAP 1.2).

Run: python bench_scatter_pack.py   (on the card)
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np
import jax
import jax.numpy as jnp

V, K, R = 25_319, 128, 6_291_456  # NSF chunk-sweep row count (64x98304)
rng = np.random.default_rng(0)
ids_rand = (V * rng.random(R) ** 3).astype(np.int32)
ids_sort = np.sort(ids_rand)
tab = jnp.asarray(rng.random((V, K), dtype=np.float32))
rows = jnp.asarray(rng.random((R, K), dtype=np.float32))


def timed(f, *a, n=5):
    float(f(*a).sum())          # warm; value fetch = real sync
    t0 = time.perf_counter()
    for _ in range(n):
        r = f(*a)
    float(r.sum())              # one fetch after n in-order executions
    return (time.perf_counter() - t0) / n


g = jax.jit(lambda t, i: t[i].sum(0))
gs = jax.jit(lambda t, i: t.at[i].get(indices_are_sorted=True,
                                      unique_indices=False).sum(0))
sc = jax.jit(lambda w, i: jax.ops.segment_sum(w, i, num_segments=V))
scs = jax.jit(lambda w, i: jax.ops.segment_sum(
    w, i, num_segments=V, indices_are_sorted=True))


def main():
    for name, f, i in (("gather_random", g, ids_rand),
                       ("gather_sorted_ids", g, ids_sort),
                       ("gather_sorted_hint", gs, ids_sort),
                       ("scatter_random", sc, ids_rand),
                       ("scatter_sorted_ids", sc, ids_sort),
                       ("scatter_sorted_hint", scs, ids_sort)):
        a = ((tab, jnp.asarray(i)) if name.startswith("gather")
             else (rows, jnp.asarray(i)))
        print(json.dumps({"variant": name,
                          "ms": round(timed(f, *a) * 1e3, 2)}), flush=True)


if __name__ == "__main__":
    main()
