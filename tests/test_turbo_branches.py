"""Regime-adaptive branch coverage at batch sizes that reach them.

The engine lax.conds between full-width / compacted / global programs on
measured counts (ops/turbo.py).  The unit tests use small batches that
always take the small-chunk lane path; these tests build batches big
enough to trace the OTHER branches on the CPU backend:

  * global patch branch:     n_dirty * 4 > 3 * B      (all-miss batch)
  * big-chunk lane branch:   2^18 < n_dirty <= 0.75*B (B = 2^19, ~60% miss)
  * compacted chain branch:  n_alive0 * 2 <= B

Exactness is checked against the LF streaming engine on sampled lanes
(full-batch LF on CPU at this size would dominate suite time).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from sbwt_tpu.models.sbwt import SBWT
from sbwt_tpu.ops.search import streaming_search_jit
from sbwt_tpu.ops.turbo import build_turbo, turbo_streaming_jit
from sbwt_tpu.utils.dna import encode_query


@pytest.fixture(scope="module")
def sb():
    rng = np.random.default_rng(5)
    g = "".join(rng.choice(list("ACGT"), size=4000))
    return g, SBWT.build([g], 14, precalc_k=6)


def _check(sb_t, codes, lengths, sample):
    g, sb = sb_t
    turbo = build_turbo(sb.device_index, arity=2)
    got = np.asarray(
        turbo_streaming_jit(
            turbo, sb.device_index, jnp.asarray(codes), jnp.asarray(lengths)
        )
    )
    ref = np.asarray(
        streaming_search_jit(
            sb.device_index, jnp.asarray(codes[sample]), jnp.asarray(lengths[sample])
        )
    )
    np.testing.assert_array_equal(got[sample], ref)


@pytest.mark.slow
def test_global_patch_branch_all_miss(sb):
    rng = np.random.default_rng(7)
    B, L = 1 << 18, 40
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    g = sb[0]
    for i in range(0, B, 997):  # a few genomic lanes stay exact too
        s = g[(i * 7) % 3000 : (i * 7) % 3000 + L]
        codes[i, : len(s)] = encode_query(s)
    lengths = np.full(B, L, dtype=np.int32)
    sample = np.concatenate([np.arange(0, B, 997), rng.integers(0, B, 512)])
    _check(sb, codes, lengths, np.unique(sample))


@pytest.mark.slow
def test_big_chunk_lane_branch_mixed(sb):
    rng = np.random.default_rng(8)
    B, L = 1 << 19, 30
    g = sb[0]
    codes = np.empty((B, L), dtype=np.int8)
    # ~40% genomic lanes (alive chains), ~60% random (dirty; between the
    # small-chunk threshold 2^18 and the global threshold 0.75*B)
    genomic = rng.random(B) < 0.4
    codes[:] = rng.integers(0, 4, size=(B, L), dtype=np.int8)
    starts = rng.integers(0, 3000, size=B)
    enc = encode_query(g)
    for i in np.flatnonzero(genomic)[:4096]:
        codes[i] = enc[starts[i] : starts[i] + L]
    lengths = np.full(B, L, dtype=np.int32)
    sample = rng.integers(0, B, 768)
    _check(sb, codes, lengths, np.unique(sample))


@pytest.mark.parametrize("hint", ["hit", "mid", "miss"])
def test_regime_hints_are_performance_only(sb, hint):
    """A static regime_hint picks which exact program runs; even a WRONG
    hint must return bit-identical answers."""
    from functools import partial
    import jax

    from sbwt_tpu.ops.turbo import turbo_streaming_search

    g, sbwt = sb
    rng = np.random.default_rng(11)
    turbo = build_turbo(sbwt.device_index, arity=3)
    B, L = 512, 40
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    for i in range(0, B, 3):  # mixed regime, so every hint is "wrong" somewhere
        s = g[(i * 13) % 3000 : (i * 13) % 3000 + L]
        codes[i, : len(s)] = encode_query(s)
    codes[5, 7] = -1
    lengths = np.full(B, L, dtype=np.int32)
    lengths[9] = 20
    auto = np.asarray(
        turbo_streaming_jit(
            turbo, sbwt.device_index, jnp.asarray(codes), jnp.asarray(lengths)
        )
    )
    fn = jax.jit(
        partial(turbo_streaming_search, regime_hint=hint)
    )
    got = np.asarray(
        fn(turbo, sbwt.device_index, jnp.asarray(codes), jnp.asarray(lengths))
    )
    np.testing.assert_array_equal(got, auto)


@pytest.mark.parametrize("k,p", [(36, 8), (45, 13)])
def test_global_patch_long_kmers_chimeric(k, p):
    """Regression: patch_global once re-derived restart
    windows from only 3 packed words, so every window char at offset
    >= 32 read as 'A' for k > 33 — chimeric reads (random prefix, genomic
    suffix) whose restarts must resolve REAL k-mers caught 2169/5670
    wrong answers at k=36.  k=45/p=13 is the widest window the packed
    path supports (rem = 32 at the max precalc length)."""
    from functools import partial
    import jax

    from sbwt_tpu.ops.turbo import turbo_streaming_search

    rng = np.random.default_rng(5)
    g = "".join(rng.choice(list("ACGT"), size=6000))
    sb = SBWT.build([g], k, precalc_k=p)
    turbo = build_turbo(sb.device_index, arity=3)
    B, L = 2048, 70
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    enc = encode_query(g)
    for i in range(0, B, 3):
        cut = int(rng.integers(1, L - k))
        s = enc[(i * 7) % 5000 : (i * 7) % 5000 + (L - cut)]
        codes[i, cut : cut + len(s)] = s
    lengths = np.full(B, L, dtype=np.int32)
    ref = np.asarray(
        streaming_search_jit(sb.device_index, jnp.asarray(codes), jnp.asarray(lengths))
    )
    for hint in ("miss", None):  # global branch: forced, then via lax.cond
        got = np.asarray(
            jax.jit(partial(turbo_streaming_search, regime_hint=hint))(
                turbo, sb.device_index, jnp.asarray(codes), jnp.asarray(lengths)
            )
        )
        np.testing.assert_array_equal(got, ref, err_msg=f"hint={hint}")


@pytest.mark.parametrize("arity", [1, 3])
def test_nonsingleton_seed_dense_all_hints(arity):
    """Adversarial mix for the slow-path machinery: a repeat-heavy corpus
    (8 mutated copies of one base) with a SHORT precalc (p=4) makes most
    live seeds non-singleton, so restarts flood the SLOW_SENTINEL pend
    path instead of the singleton walk.  Every hint must stay exact on
    chimeric + all-miss + genomic lanes."""
    from functools import partial
    import jax

    from sbwt_tpu.ops.turbo import turbo_streaming_search

    rng = np.random.default_rng(21)
    base = rng.choice(list("ACGT"), size=1500)
    parts = []
    for i in range(8):
        c = base.copy()
        pos = rng.choice(len(base), size=15 * (i + 1), replace=False)
        c[pos] = rng.choice(list("ACGT"), size=len(pos))
        parts.append("".join(c))
    sb = SBWT.build(parts, 14, precalc_k=4)
    turbo = build_turbo(sb.device_index, arity=arity)
    g = parts[0]
    B, L = 1024, 40
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    enc = encode_query(g)
    for i in range(0, B, 3):  # genomic
        codes[i, :] = enc[(i * 11) % 1400 : (i * 11) % 1400 + L]
    for i in range(1, B, 3):  # chimeric: restart must resolve real k-mers
        cut = int(rng.integers(1, L - 14))
        s = enc[(i * 7) % 1400 : (i * 7) % 1400 + (L - cut)]
        codes[i, cut : cut + len(s)] = s
    lengths = np.full(B, L, dtype=np.int32)
    ref = np.asarray(
        streaming_search_jit(sb.device_index, jnp.asarray(codes), jnp.asarray(lengths))
    )
    for hint in (None, "hit", "mid", "miss"):
        got = np.asarray(
            jax.jit(partial(turbo_streaming_search, regime_hint=hint))(
                turbo, sb.device_index, jnp.asarray(codes), jnp.asarray(lengths)
            )
        )
        np.testing.assert_array_equal(got, ref, err_msg=f"arity={arity} hint={hint}")
