"""Wide-engine turbo tier (ops/turbo.py WideTurboIndex).

The int64 engine (n >= 2^31, models/wide.py) previously queried at LF
speed only; the arity-1 successor-row tier stores int64 successors as
(lo, hi) int32 pairs in [n, 8] rows — one row gather per chain answer.
x64 is a process-global jax flag, so the test runs in a subprocess
(the tests/test_wide_index.py pattern).  Output must equal the wide LF
engine bit for bit across hit-heavy, all-miss, repetitive
(non-singleton-seed), mid-read-N and lowercase lanes.
"""
import os
import subprocess
import sys
import textwrap

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_SCRIPT = textwrap.dedent(
    """
    import os
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from sbwt_tpu.construct.inmemory import build_sbwt
    from sbwt_tpu.models.wide import from_packed_rows_wide
    from sbwt_tpu.ops import bitvector as bv
    from sbwt_tpu.ops import search as engines
    from sbwt_tpu.ops.turbo import (
        WideTurboIndex, build_turbo, fast_search_jit, turbo_streaming_jit,
    )
    from sbwt_tpu.utils.dna import encode_query

    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACGT"), size=900)) for _ in range(2)]
    seqs.append("ACGT" * 80)  # repetitive: non-singleton seeds
    built = build_sbwt(seqs, 12)
    words = np.stack([bv.pack_bits_host(built.bits[c]) for c in range(4)])
    sgs_w = bv.pack_bits_host(built.suffix_group_starts)
    wide = from_packed_rows_wide(words, built.bits.shape[1], sgs_w,
                                 k=12, n_kmers=built.n_kmers, precalc_k=6)
    wt = build_turbo(wide, arity=1)  # wide indexes route to the pair-row tier
    assert isinstance(wt, WideTurboIndex)
    assert wt.tbl.shape[1] == 4 and wt.tbl.dtype == jnp.int32
    assert wt.tbl_hi.shape == wt.tbl.shape  # split (lo, hi) row tables

    L = 80
    reads = np.full((48, L), -1, dtype=np.int8)
    lens = np.zeros(48, dtype=np.int32)
    for i in range(48):
        ln = int(rng.integers(16, L))
        if i % 3 == 0:
            st = int(rng.integers(0, 900 - ln))
            s = seqs[0][st:st + ln]
        elif i % 3 == 1:
            s = "".join(rng.choice(list("ACGT"), size=ln))
        else:
            s = ("ACGT" * 40)[:ln]
        reads[i, :ln] = encode_query(s)
        lens[i] = ln
    reads[5, 10] = -1  # N mid-read
    reads[7, 20:24] = encode_query("acgt")  # lowercase: extend-valid only

    ref = np.asarray(engines.streaming_search_jit(
        wide, jnp.asarray(reads), jnp.asarray(lens)))
    got = np.asarray(turbo_streaming_jit(
        wt, wide, jnp.asarray(reads), jnp.asarray(lens)))
    assert got.dtype == np.int64
    assert np.array_equal(got, ref), "wide turbo streaming mismatch"

    kmers = np.stack([
        encode_query("".join(rng.choice(list("ACGT"), size=12)))
        for _ in range(256)
    ])
    a = np.asarray(engines.search_jit(wide, jnp.asarray(kmers)))
    ans, slow = fast_search_jit(wt, jnp.asarray(kmers))
    ans, slow = np.asarray(ans), np.asarray(slow)
    assert np.array_equal(ans[~slow], a[~slow]), "wide fast_search mismatch"
    print("OK")
    """
)


def test_wide_turbo_matches_wide_lf_engine():
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
        env=env, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK" in proc.stdout


def test_wide_pair_row_path_matches_lo_path():
    """The n >= 2^31 (lo, hi) pair path is unreachable on one chip (the
    table could not fit), so pin its semantics directly: with hi = 0/-1
    it must agree with the single-chip lo-only fast path."""
    import dataclasses
    import jax.numpy as jnp
    import numpy as np
    from sbwt_tpu.ops.turbo import WideTurboIndex

    rng = np.random.default_rng(3)
    n = 64
    lo = rng.integers(-1, n, size=(n, 4)).astype(np.int32)
    hi = np.where(lo < 0, -1, 0).astype(np.int32)
    mk = lambda nn: WideTurboIndex(
        tbl=jnp.asarray(lo), tbl_hi=jnp.asarray(hi),
        precalc=jnp.zeros((1, 2), jnp.int64), C=jnp.zeros(4, jnp.int64),
        n_nodes=nn, k=8, precalc_k=0,
    )
    small, big = mk(n), mk(2**31 + 5)
    idx = jnp.arange(n, dtype=jnp.int64)
    for c in range(4):
        cc = jnp.full((n,), c, jnp.int32)
        alive = jnp.ones((n,), bool)
        s_small = small.succ_from_row(small.tbl_row(idx), cc, alive)
        s_big = big.succ_from_row(big.tbl_row(idx), cc, alive)
        np.testing.assert_array_equal(np.asarray(s_small), np.asarray(s_big))
