"""Microbenchmark: beta-stat scatter variants at NSF K=100 chunk shapes.

Variants:
  A  direct segment_sum (current production path)
  B  host-precomputed vocab-sort perm -> gather + sorted segment_sum
  C  B + truncation of padding tail
  D  one-hot matmul partial dedup (G=8 groups)   [optional]
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np
import jax, jax.numpy as jnp

B, L, K, V = 1024, 96, 100, 25_319
NCHUNK = 64
rng = np.random.default_rng(0)

u = rng.random((NCHUNK, B, L), dtype=np.float32)
terms = np.minimum((V * u**3).astype(np.int32), V - 1)
nreal = rng.integers(int(L * 0.6), L, size=(NCHUNK, B))
valid = np.arange(L)[None, None, :] < nreal[..., None]
counts = (1 + rng.poisson(0.35, size=(NCHUNK, B, L))).astype(np.float32) * valid
terms = terms * valid

# host-precomputed per-chunk perms
perms = np.zeros((NCHUNK, B * L), np.int32)
ids_sorted = np.zeros((NCHUNK, B * L), np.int32)
n_real_max = 0
for c in range(NCHUNK):
    ids = terms[c].reshape(-1)
    cnt = counts[c].reshape(-1)
    key = np.where(cnt > 0, ids, V)
    p = np.argsort(key, kind="stable").astype(np.int32)
    perms[c] = p
    ids_sorted[c] = np.where(cnt.reshape(-1)[p] > 0, ids[p], V - 1)
    n_real_max = max(n_real_max, int((cnt > 0).sum()))
T_keep = min(B * L, ((n_real_max + 511) // 512) * 512)
print(f"B*L={B*L}, T_keep={T_keep} ({100*T_keep/(B*L):.0f}%)", file=sys.stderr)

w_np = (rng.random((NCHUNK, B, L, K), dtype=np.float32) * counts[..., None])

terms_d = jnp.asarray(terms)
w_d = jnp.asarray(w_np)
perms_d = jnp.asarray(perms)
ids_d = jnp.asarray(ids_sorted)
perms_t = jnp.asarray(perms[:, :T_keep])
ids_t = jnp.asarray(ids_sorted[:, :T_keep])


@jax.jit
def variant_a(w, t):
    def body(acc, xs):
        wi, ti = xs
        return acc + jax.ops.segment_sum(
            wi.reshape(-1, K), ti.reshape(-1), num_segments=V), None
    acc, _ = jax.lax.scan(body, jnp.zeros((V, K), jnp.float32), (w, t))
    return acc


@jax.jit
def variant_b(w, perm, ids):
    def body(acc, xs):
        wi, pi, ii = xs
        ws = jnp.take(wi.reshape(-1, K), pi, axis=0)
        return acc + jax.ops.segment_sum(
            ws, ii, num_segments=V, indices_are_sorted=True), None
    acc, _ = jax.lax.scan(body, jnp.zeros((V, K), jnp.float32), (w, perm, ids))
    return acc


def timed(f, *args, n=3):
    r = f(*args); float(jnp.sum(r))
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        r = f(*args); float(jnp.sum(r))
        best = min(best, time.perf_counter() - t0)
    return best, r


ta, ra = timed(variant_a, w_d, terms_d)
tb, rb = timed(variant_b, w_d, perms_d, ids_d)
tc, rc = timed(variant_b, w_d, perms_t, ids_t)
np.testing.assert_allclose(np.asarray(ra), np.asarray(rb), rtol=1e-5, atol=1e-4)
np.testing.assert_allclose(np.asarray(ra), np.asarray(rc), rtol=1e-5, atol=1e-4)
tok = NCHUNK * B * L
print(f"A direct unsorted : {ta*1e3:8.2f} ms  ({tok/ta/1e6:.1f} Mtok/s)")
print(f"B sorted full     : {tb*1e3:8.2f} ms  ({tok/tb/1e6:.1f} Mtok/s)")
print(f"C sorted truncated: {tc*1e3:8.2f} ms  ({NCHUNK*T_keep/tc/1e6:.1f} Mtok/s eff)")


# ── variant D: one-hot matmul dedup over variable-size sorted groups ──
# NOTE: this is a *performance* prototype. Its padding path is knowingly
# incomplete (group padding gathers slot p[0]/p[-1], which may be a real
# token, so the result differs from A) — fixing it adds no row traffic,
# so the timing is representative.  D was never productionised; it is
# not yet measured on the H100 (ROADMAP 1.2).
GT, UD = 512, 128  # tokens per group, distinct-id cap per group

def build_groups(ids, cnt):
    """Host: sorted stream -> groups of <=GT tokens with <=UD distinct ids."""
    key = np.where(cnt > 0, ids, V)
    p = np.argsort(key, kind="stable")
    sid = ids[p]
    real = cnt[p] > 0
    n_real = int(real.sum())
    gidx, lslot, oid = [], [], []
    i = 0
    while i < n_real:
        # how far can this group extend: <=GT tokens and <=UD distinct
        j = min(i + GT, n_real)
        seg = sid[i:j]
        bounds = np.nonzero(np.diff(seg))[0] + 1          # run starts
        starts = np.concatenate([[0], bounds])
        if starts.size > UD:
            j = i + int(starts[UD])                        # cut at UD-th run
            seg = sid[i:j]
            starts = starts[:UD]
        n = j - i
        g = np.full(GT, p[0], np.int32)   # pad gather with slot 0 (could be real!)
        g[:n] = p[i:j]
        pad_ok = np.zeros(GT, bool); pad_ok[:n] = True
        ls = np.zeros(GT, np.int32)
        run_id = np.searchsorted(starts, np.arange(n), side="right") - 1
        ls[:n] = run_id
        # padding tokens -> slot UD-1 with a zero-contribution: map gather to a
        # zero-count slot instead: find one padded slot in chunk
        zero_slot = p[-1] if cnt[p[-1]] == 0 else None
        if zero_slot is not None:
            g[n:] = zero_slot
            ls[n:] = UD - 1
        o = np.full(UD, V - 1, np.int32)
        uniq = seg[starts]
        o[: uniq.size] = uniq
        gidx.append(g); lslot.append(ls); oid.append(o)
        i = j
    return (np.stack(gidx), np.stack(lslot), np.stack(oid))

g_all, l_all, o_all = [], [], []
ng_max = 0
for c in range(NCHUNK):
    g, l, o = build_groups(terms[c].reshape(-1), counts[c].reshape(-1))
    g_all.append(g); l_all.append(l); o_all.append(o)
    ng_max = max(ng_max, g.shape[0])
print(f"D: groups/chunk max {ng_max} -> scatter rows {ng_max*UD} vs {B*L}",
      file=sys.stderr)
for c in range(NCHUNK):
    g, l, o = g_all[c], l_all[c], o_all[c]
    pad = ng_max - g.shape[0]
    if pad:
        # empty groups: gather a zero-count slot, out ids V-1
        zp = np.full((pad, GT), g[0, -1], np.int32)
        g_all[c] = np.concatenate([g, zp])
        l_all[c] = np.concatenate([l, np.zeros((pad, GT), np.int32)])
        o_all[c] = np.concatenate([o, np.full((pad, UD), V - 1, np.int32)])
gd = jnp.asarray(np.stack(g_all)); ld = jnp.asarray(np.stack(l_all))
od = jnp.asarray(np.stack(o_all))


@jax.jit
def variant_d(w, gidx, lslot, oid):
    def body(acc, xs):
        wi, gi, li, oi = xs
        wg = jnp.take(wi.reshape(-1, K), gi.reshape(-1), axis=0)
        wg = wg.reshape(gi.shape + (K,))                  # [ng, GT, K]
        oh = jax.nn.one_hot(li, UD, dtype=jnp.float32)    # [ng, GT, UD]
        part = jnp.einsum("gtu,gtk->guk", oh, wg,
                          preferred_element_type=jnp.float32)
        return acc + jax.ops.segment_sum(
            part.reshape(-1, K), oi.reshape(-1), num_segments=V), None
    acc, _ = jax.lax.scan(body, jnp.zeros((V, K), jnp.float32),
                          (w, gidx, lslot, oid))
    return acc


# correctness needs padded gather slots to be zero-count; verify & time
td, rd = timed(variant_d, w_d, gd, ld, od)
err = np.abs(np.asarray(rd) - np.asarray(ra)).max()
print(f"D onehot-dedup    : {td*1e3:8.2f} ms  (max abs err {err:.2e})")


# ── variants E/F/G: row-width/dtype effects on the direct scatter ──
@jax.jit
def variant_e(w, t):  # bf16 rows, bf16 accumulate
    def body(acc, xs):
        wi, ti = xs
        return acc + jax.ops.segment_sum(
            wi.reshape(-1, K).astype(jnp.bfloat16), ti.reshape(-1),
            num_segments=V), None
    acc, _ = jax.lax.scan(body, jnp.zeros((V, K), jnp.bfloat16), (w, t))
    return acc


Kp = 128
@jax.jit
def variant_f(w, t):  # f32 rows padded to 128 lanes
    def body(acc, xs):
        wi, ti = xs
        wp = jnp.pad(wi.reshape(-1, K), ((0, 0), (0, Kp - K)))
        return acc + jax.ops.segment_sum(wp, ti.reshape(-1),
                                         num_segments=V), None
    acc, _ = jax.lax.scan(body, jnp.zeros((V, Kp), jnp.float32), (w, t))
    return acc[:, :K]


te, re_ = timed(variant_e, w_d, terms_d)
tf, rf = timed(variant_f, w_d, terms_d)
np.testing.assert_allclose(np.asarray(rf), np.asarray(ra), rtol=1e-6)
print(f"E bf16 rows       : {te*1e3:8.2f} ms")
print(f"F f32 K->128 pad  : {tf*1e3:8.2f} ms")


# ── variant H: scatter-add straight into the scan carry ──
@jax.jit
def variant_h(w, t):
    def body(acc, xs):
        wi, ti = xs
        return acc.at[ti.reshape(-1)].add(wi.reshape(-1, K)), None
    acc, _ = jax.lax.scan(body, jnp.zeros((V, K), jnp.float32), (w, t))
    return acc


th, rh = timed(variant_h, w_d, terms_d)
np.testing.assert_allclose(np.asarray(rh), np.asarray(ra), rtol=1e-6)
print(f"H carry scatter   : {th*1e3:8.2f} ms")
