"""Batched SBWT query engines (jit-compiled, lockstep over lanes).

The reference answers one query at a time with scalar rank calls
(SBWT.hh:390-437, 545-581).  On the device the same math runs as lockstep vector
programs: thousands of query lanes advance one LF step per iteration, each
step costing one or two contiguous 8-byte gathers from the fused
(bits, cum) rank table.

Engines:
  * update_interval_batch — vectorized update_sbwt_interval (SBWT.hh:423-437)
  * search_batch          — vectorized search with precalc seeding (SBWT.hh:390-415)
  * streaming_chain + streaming_search — vectorized streaming_search
    (SBWT.hh:545-581).  The suffix-group left-walk becomes a branch-free
    4-bit scan (suffix groups have at most 4 members, so the walk is
    bounded); chain breaks are patched by a dynamically-sized second pass
    of full searches, preserving exact output equality with per-k-mer
    search (the documented contract, SBWT.hh:231).
  * partial_search_batch  — vectorized partial_search (SBWT.hh:526-537)
  * forward_batch         — vectorized forward (SBWT.hh:369-381)
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

_ONE = np.uint32(1)

# Transient patch-stage marker (real answers are always >= -1): stage A
# of the streaming patch writes it for unresolved positions whose precalc
# seed is live; stage B replaces every occurrence before returning.
STAGE_SENTINEL = -2


def compact_indices(mask):
    """Indices of True entries, compacted to the front; tail filled with
    len(mask) (a drop sentinel).  cumsum+scatter instead of jnp.nonzero,
    whose size= path lowers to a full sort.  Returns (work, count)."""
    mask = mask.ravel()
    total = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    count = pos[-1] + 1 if total else jnp.int32(0)
    dest = jnp.where(mask, pos, total)
    work = jnp.full(total + 1, total, dtype=jnp.int32)
    src = jnp.arange(total, dtype=jnp.int32)
    work = work.at[dest].set(src, mode="drop")
    return work[:total], count


def lf_step(index, l, r, c, alive):
    """One LF iteration on intervals [l, r] for character codes c (SBWT.hh:430-433)."""
    Cc = index.C[c]
    l2 = Cc + index.rank_c(c, l)
    r2 = Cc + index.rank_c(c, r + 1) - 1
    alive2 = alive & (l2 <= r2)
    l = jnp.where(alive2, l2, l)
    r = jnp.where(alive2, r2, r)
    return l, r, alive2


def update_interval_batch(index, codes, l0, r0):
    """Run LF iterations for each lane's code sequence codes [B, m].

    Lanes with an invalid code (< 0) or an emptied interval go dead and
    freeze; returns (l, r, alive).
    """
    codes = codes.astype(jnp.int32)

    def step(carry, ct):
        l, r, alive = carry
        valid = ct >= 0  # lowercase codes 4..7 are valid here (toupper semantics)
        cc = jnp.clip(ct, 0) & 3
        l2, r2, alive2 = lf_step(index, l, r, cc, alive & valid)
        return (l2, r2, alive2), None

    (l, r, alive), _ = lax.scan(step, (l0, r0, jnp.ones_like(l0, dtype=bool)), codes.T)
    return l, r, alive


def search_batch(index, codes):
    """Vectorized SBWT::search over a batch of k-mers.

    codes: int [B, k] with values 0..3 (4..7 = lowercase and < 0 = other
    characters are both invalid here, matching SBWT.hh:426-427 which
    rejects anything but uppercase ACGT in per-k-mer search).
    Returns int32 [B]: the colex rank of each k-mer, or -1 if absent or
    containing an invalid character.
    """
    B, k = codes.shape
    assert k == index.k, f"query length {k} != index k {index.k}"
    codes = codes.astype(jnp.int32)
    p = index.precalc_k
    valid = jnp.all((codes >= 0) & (codes < 4), axis=1)
    cc = jnp.clip(codes, 0) & 3
    if p > 0:
        weights = jnp.asarray(4 ** np.arange(p, dtype=np.int64), dtype=jnp.int32)
        pidx = jnp.sum(cc[:, :p] * weights, axis=1)
        seed = index.precalc[pidx]
        l, r = seed[:, 0], seed[:, 1]
        alive0 = l >= 0
        l = jnp.where(alive0, l, 0)
        r = jnp.where(alive0, r, 0)
    else:
        dt = getattr(index, "pos_dtype", jnp.int32)
        l = jnp.zeros(B, dtype=dt)
        r = jnp.full(B, index.n_nodes - 1, dtype=dt)
        alive0 = jnp.ones(B, dtype=bool)

    def step(carry, ct):
        l, r, alive = carry
        l2, r2, alive2 = lf_step(index, l, r, ct, alive)
        return (l2, r2, alive2), None

    if k - p > 0:
        (l, r, alive), _ = lax.scan(step, (l, r, alive0), cc[:, p:].T)
    else:
        alive = alive0
    # A found k-mer interval is always a singleton (SBWT.hh:410-414).
    return jnp.where(valid & alive, l, -1)


def extend_from_column(index, col, c):
    """Follow the out-edge labeled c from the suffix group of column col.

    Returns the successor column or -1 (the streaming inner step,
    SBWT.hh:566-577).  On the plain-matrix layout the group's edge bit and
    the rank below it come from one fused gather (extend_rank)."""
    s = index.sg_start(col)
    r1, bit = index.extend_rank(c, s)
    return jnp.where(bit == 1, index.C[c] + r1, -1)


def forward_batch(index, nodes, c):
    """Vectorized SBWT::forward (SBWT.hh:369-381)."""
    return extend_from_column(index, nodes, c)


def streaming_chain(index, codes):
    """Phase 1 of streaming search: the cheap extension chain.

    codes: int [B, L].  Returns (ans [B, P], unresolved [B, P]) with
    P = L - k + 1: chained answers are exact until the first -1 in each
    lane; positions after a -1 are unresolved and must be patched with
    full searches (the reference restarts with search(), SBWT.hh:557-559).
    """
    B, L = codes.shape
    k = index.k
    P = L - k + 1
    codes = codes.astype(jnp.int32)
    col0 = search_batch(index, codes[:, :k])

    def step(col, ct):
        valid = ct >= 0  # lowercase is valid in the extension (SBWT.hh:565-566)
        cc = jnp.clip(ct, 0) & 3
        nxt = extend_from_column(index, jnp.clip(col, 0), cc)
        nxt = jnp.where((col >= 0) & valid, nxt, -1)
        return nxt, nxt

    if P > 1:
        _, rest = lax.scan(step, col0, codes[:, k:].T)
        ans = jnp.concatenate([col0[:, None], rest.T], axis=1)
    else:
        ans = col0[:, None]
    unresolved = jnp.concatenate(
        [jnp.zeros((B, 1), dtype=bool), ans[:, :-1] == -1], axis=1
    )
    return ans, unresolved


def _patch_chunk(total: int) -> int:
    """Shape-adaptive patch chunk: largest power of two <= total/16,
    clamped to [4096, 2^20].  A fixed small chunk is pathological on
    miss-heavy inputs — at 150M flat positions nearly all unresolved,
    4096-lane chunks mean ~36k sequential fori_loop iterations in ONE
    device program.  Scaling the chunk with the batch keeps the trip
    count bounded and many gathers in flight per trip."""
    v = max(4096, min(total // 16, 1 << 20))
    return 1 << (int(v).bit_length() - 1)


def streaming_search(index, codes, lengths=None, chunk=None, sync_axes=None):
    """Exact streaming search: chain + staged dynamically-sized patch.

    codes: int [B, L] (pad with -1); lengths: optional int [B] actual read
    lengths.  Returns int32 [B, L-k+1]; positions beyond a read's length
    are -1.  Output equals per-k-mer search at every position (the
    contract of SBWT::streaming_search, SBWT.hh:231).

    The patch runs in two stages when the index has a precalc table:
    stage A gathers only each unresolved position's precalc seed (~2
    gathers) and answers the ~94% of random-read restarts whose seed is
    empty with -1 outright; stage B runs the exact LF continuation only
    on the survivors.  A single-stage patch (full k-step search per
    unresolved position, ~2k dependent gathers) made all-miss batches
    ~16x more expensive in dependent gathers.

    sync_axes: mesh axis names over which the patch-pass trip counts must
    be maximized (required when the index gathers psum over a model axis
    inside shard_map: collectives must run the same number of times on
    every device).
    """
    B, L = codes.shape
    k = index.k
    P = L - k + 1
    if chunk is None:
        chunk = _patch_chunk(B * P)
    ans, unresolved = streaming_chain(index, codes)

    if lengths is not None:
        pos_ok = jnp.arange(P)[None, :] <= (lengths[:, None] - k)
        unresolved = unresolved & pos_ok

    flat_mask = unresolved.ravel()
    total = B * P
    chunk = min(chunk, total)
    # Compact the unresolved flat positions; fill with `total` (dropped on scatter).
    work, count = compact_indices(flat_mask)

    codes_flat = codes.ravel().astype(jnp.int32)
    karange = jnp.arange(k, dtype=jnp.int32)

    def _sync(c):
        return lax.pmax(c, sync_axes) if sync_axes else c

    def _window(sel, width):
        selc = jnp.clip(sel, 0, total - 1)
        base = selc // P * L + selc % P
        return codes_flat[
            jnp.clip(base[:, None] + karange[None, :width], 0, B * L - 1)
        ]

    p = getattr(index, "precalc_k", 0)
    if p <= 0 or k == p:
        # no precalc (or seed already decides): single-stage full search
        def body(i, ans_flat):
            sel = lax.dynamic_slice(work, (i * chunk,), (chunk,))
            res = search_batch(index, _window(sel, k))
            return ans_flat.at[sel].set(res, mode="drop")

        n_iters = _sync((count + chunk - 1) // chunk)
        ans_flat = lax.fori_loop(0, n_iters, body, ans.ravel())
    else:
        weights = jnp.asarray(4 ** np.arange(p, dtype=np.int64), dtype=jnp.int32)

        # ---- stage A: seed-only triage ---------------------------------
        # -1 for dead seeds / invalid windows; STAGE_SENTINEL for live
        # seeds, resolved in stage B below.
        def body_a(i, ans_flat):
            sel = lax.dynamic_slice(work, (i * chunk,), (chunk,))
            win = _window(sel, p)  # only the seed's p characters
            ok = jnp.all((win >= 0) & (win < 4), axis=1)
            pidx = jnp.sum((jnp.clip(win, 0) & 3) * weights, axis=1)
            l0 = index.precalc[pidx][:, 0]
            res = jnp.where(ok & (l0 >= 0), jnp.int32(STAGE_SENTINEL), -1)
            return ans_flat.at[sel].set(res.astype(ans_flat.dtype), mode="drop")

        n_a = _sync((count + chunk - 1) // chunk)
        ans_flat = lax.fori_loop(0, n_a, body_a, ans.ravel())

        # ---- stage B: exact search on surviving positions --------------
        # The seed's validity says nothing about characters p..k-1, and a
        # live seed can still be absent after the LF continuation —
        # search_batch re-derives both exactly.  Survivors are a small
        # minority on random inputs, so the full-search chunks pool FAR
        # fewer trips than a single-stage patch.
        work_b, count_b = compact_indices(ans_flat == STAGE_SENTINEL)
        # survivors are ~6% of unresolved on random inputs: size the full-
        # search chunks down so a near-empty stage B doesn't pay a padded
        # maximal-width trip
        cb = min(max(chunk // 4, 4096), total)

        def body_b(i, ans_flat):
            sel = lax.dynamic_slice(work_b, (i * cb,), (cb,))
            res = search_batch(index, _window(sel, k))
            return ans_flat.at[sel].set(res, mode="drop")

        n_b = _sync((count_b + cb - 1) // cb)
        ans_flat = lax.fori_loop(0, n_b, body_b, ans_flat)

    ans = ans_flat.reshape(B, P)
    if lengths is not None:
        pos_ok = jnp.arange(P)[None, :] <= (lengths[:, None] - k)
        ans = jnp.where(pos_ok, ans, -1)
    return ans


def partial_search_batch(index, codes, lengths=None):
    """Vectorized SBWT::partial_search (SBWT.hh:526-537).

    Returns (l, r, matched_len): the interval of the longest matching
    prefix of each lane's sequence and its length.
    """
    B, L = codes.shape
    codes = codes.astype(jnp.int32)
    dt = getattr(index, "pos_dtype", jnp.int32)
    l0 = jnp.zeros(B, dtype=dt)
    r0 = jnp.full(B, index.n_nodes - 1, dtype=dt)
    alive0 = jnp.ones(B, dtype=bool)
    mlen0 = jnp.zeros(B, dtype=jnp.int32)

    def step(carry, xs):
        l, r, alive, mlen = carry
        ct, t = xs
        valid = ct >= 0  # partial_search uppercases its input (SBWT.hh:531)
        if lengths is not None:
            valid = valid & (t < lengths)
        cc = jnp.clip(ct, 0) & 3
        l2, r2, alive2 = lf_step(index, l, r, cc, alive & valid)
        mlen = jnp.where(alive2, t + 1, mlen)
        return (l2, r2, alive2, mlen), None

    ts = jnp.arange(L, dtype=jnp.int32)
    (l, r, alive, mlen), _ = lax.scan(
        step, (l0, r0, alive0, mlen0), (codes.T, ts)
    )
    return l, r, mlen


# Module-level jitted entry points (cached across calls).
update_interval_jit = jax.jit(update_interval_batch)
search_jit = jax.jit(search_batch)
streaming_search_jit = jax.jit(streaming_search)
forward_jit = jax.jit(forward_batch)
