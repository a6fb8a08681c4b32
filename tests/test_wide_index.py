"""The int64 (>= 2^31 columns) engine.

Two subprocess tests (x64 is a process-global jax flag, so each runs in
its own interpreter):

* differential: the wide engine must answer exactly like the narrow int32
  engine on the same bits, across search / streaming / partial / forward;
* scale: a REAL 4.29-billion-column index — the complete order-16
  de Bruijn graph (all 4^16 k-mers + root), whose SBWT has closed-form
  structure (all-ones rows, C[c] = 1 + c*4^16 > 2^31) and a closed-form
  query oracle: search(x) = 1 + sum_i code_i * 4^i.  Built from packed
  words via models.matrix.from_packed_rows, which must auto-select the
  wide engine (SBWT.hh:44-46 int64 parity).
"""
import os
import subprocess
import sys
import textwrap

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, timeout: int):
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env=env, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


_DIFFERENTIAL = textwrap.dedent(
    """
    import os
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from sbwt_tpu.construct.inmemory import build_sbwt
    from sbwt_tpu.models.matrix import from_host_arrays
    from sbwt_tpu.models.wide import from_packed_rows_wide, wide_with_precalc
    from sbwt_tpu.ops import bitvector as bv
    from sbwt_tpu.ops import search as engines
    from sbwt_tpu.utils.dna import encode_query

    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACGT"), size=600)) for _ in range(2)]
    built = build_sbwt(seqs, 11)
    narrow = from_host_arrays(built.bits, built.suffix_group_starts,
                              k=11, n_kmers=built.n_kmers, precalc_k=3)
    words = np.stack([bv.pack_bits_host(built.bits[c]) for c in range(4)])
    sgs_w = bv.pack_bits_host(built.suffix_group_starts)
    wide = from_packed_rows_wide(words, built.bits.shape[1], sgs_w,
                                 k=11, n_kmers=built.n_kmers, precalc_k=3)
    assert np.array_equal(np.asarray(narrow.precalc), np.asarray(wide.precalc))

    kmers = np.stack([encode_query("".join(rng.choice(list("ACGT"), size=11)))
                      for _ in range(512)])
    a = np.asarray(engines.search_jit(narrow, jnp.asarray(kmers)))
    b = np.asarray(engines.search_jit(wide, jnp.asarray(kmers)))
    assert np.array_equal(a, b), "search mismatch"

    L = 80
    reads = np.full((64, L), -1, dtype=np.int8)
    lens = np.zeros(64, dtype=np.int32)
    for i in range(64):
        ln = int(rng.integers(15, L))
        if i % 2 == 0:
            st = int(rng.integers(0, 600 - ln))
            s = seqs[0][st:st + ln]
        else:
            s = "".join(rng.choice(list("ACGT"), size=ln))
        reads[i, :ln] = encode_query(s)
        lens[i] = ln
    a = np.asarray(engines.streaming_search_jit(narrow, jnp.asarray(reads), jnp.asarray(lens)))
    b = np.asarray(engines.streaming_search_jit(wide, jnp.asarray(reads), jnp.asarray(lens)))
    assert np.array_equal(a, b), "streaming mismatch"

    la, ra, ma = engines.partial_search_batch(narrow, jnp.asarray(reads), jnp.asarray(lens))
    lb, rb, mb = engines.partial_search_batch(wide, jnp.asarray(reads), jnp.asarray(lens))
    assert np.array_equal(np.asarray(la), np.asarray(lb))
    assert np.array_equal(np.asarray(ra), np.asarray(rb))
    assert np.array_equal(np.asarray(ma), np.asarray(mb))

    nodes = rng.integers(0, built.bits.shape[1], size=256)
    for c in range(4):
        fa = np.asarray(engines.forward_jit(narrow, jnp.asarray(nodes, dtype=jnp.int32),
                                            jnp.full(256, c, dtype=jnp.int32)))
        fb = np.asarray(engines.forward_jit(wide, jnp.asarray(nodes, dtype=jnp.int64),
                                            jnp.full(256, c, dtype=jnp.int32)))
        assert np.array_equal(fa, fb), f"forward mismatch c={c}"
    print("DIFFERENTIAL-OK")
    """
)


_GIANT = textwrap.dedent(
    """
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sbwt_tpu.models.matrix import from_packed_rows
    from sbwt_tpu.models.wide import WideMatrixIndex
    from sbwt_tpu.ops import search as engines
    from sbwt_tpu.ops import bitvector as bvops

    def complete_dbg_words(K):
        # Complete order-K de Bruijn graph SBWT: columns = root + all 4^K
        # k-mers in colex order.  Suffix groups are runs of 4 (k-mers
        # sharing a (K-1)-suffix differ only in their first char, the
        # colex-fastest digit), and only the group REPRESENTATIVE column
        # carries the group's out-edges (all four) — the subset structure
        # of the SBWT.  Reps are k-mer indices m % 4 == 0 -> columns
        # j % 4 == 1, i.e. the 0x22222222 bit pattern in every row.
        NK = 4 ** K
        N = NK + 1
        W = N // 32 + 1
        row = np.full(W, 0x22222222, dtype=np.uint32)
        row[-1] = 0x00000000   # the final word holds only column N-1 (j%4==0)
        words = np.stack([row] * 4)
        sgs = row.copy()
        sgs[0] = 0x22222223    # root column is always marked
        return words, sgs, N, NK

    # --- self-check the synthetic pattern against the real constructor ---
    KS = 8
    from sbwt_tpu.construct.inmemory import build_from_kmers
    from sbwt_tpu.utils import kmers as km
    allk = []
    for v in range(4 ** KS):
        codes = np.array([(v >> (2 * i)) & 3 for i in range(KS)], dtype=np.int8)
        allk.append(km.pack_windows(codes, KS)[0][0])
    built = build_from_kmers(np.unique(np.array(allk, dtype=np.uint64)), KS)
    w_s, sgs_s, N_s, NK_s = complete_dbg_words(KS)
    for c in range(4):
        assert np.array_equal(bvops.pack_bits_host(built.bits[c]), w_s[c]), c
    assert np.array_equal(bvops.pack_bits_host(built.suffix_group_starts), sgs_s)
    print("PATTERN-OK")

    K = 16
    words, sgs, N, NK = complete_dbg_words(K)  # N = 4^16 + 1 > 2^32
    W = N // 32 + 1

    index = from_packed_rows(words, N, sgs, k=K, n_kmers=NK, precalc_k=2)
    assert isinstance(index, WideMatrixIndex), type(index)  # auto-routed
    assert int(np.asarray(index.C)[3]) == 1 + 3 * (NK // 4)  # > 2^31

    rng = np.random.default_rng(0)
    pows = 4 ** np.arange(K, dtype=np.int64)

    def oracle(codes):  # colex rank + 1 (root at column 0)
        return 1 + (codes.astype(np.int64) * pows).sum(axis=-1)

    qs = rng.integers(0, 4, size=(2048, K)).astype(np.int8)
    qs[0, :] = 0          # AAAA... -> 1
    qs[1, :] = 3          # TTTT... -> N - 1
    got = np.asarray(engines.search_jit(index, jnp.asarray(qs)))
    want = oracle(qs)
    assert got.dtype == np.int64
    assert np.array_equal(got, want), (got[:4], want[:4])
    assert want.max() > 2**31  # the oracle really exercises 64-bit ranks

    # streaming: every window of a random read is present; check all
    L = 48
    reads = rng.integers(0, 4, size=(64, L)).astype(np.int8)
    lens = np.full(64, L, dtype=np.int32)
    ans = np.asarray(engines.streaming_search_jit(index, jnp.asarray(reads), jnp.asarray(lens)))
    for i in range(64):
        for p in range(L - K + 1):
            assert ans[i, p] == oracle(reads[i, p:p + K]), (i, p)

    # forward: column(x) --c--> column(suffix(x) . c)
    cols = np.asarray(jnp.asarray(oracle(qs[:256]), dtype=jnp.int64))
    for c in range(4):
        nxt = np.asarray(engines.forward_jit(
            index, jnp.asarray(cols, dtype=jnp.int64), jnp.full(256, c, dtype=jnp.int32)))
        succ = np.concatenate([qs[:256, 1:], np.full((256, 1), c, dtype=np.int8)], axis=1)
        assert np.array_equal(nxt, oracle(succ)), f"forward c={c}"

    # partial search: interval of all k-mers ending with the query
    l, r, m = engines.partial_search_batch(index, jnp.asarray(qs[:8, :5].astype(np.int32)))
    l, r, m = np.asarray(l), np.asarray(r), np.asarray(m)
    for i in range(8):
        lo = 1 + int((qs[i, :5].astype(np.int64) * (4 ** np.arange(K - 5, K, dtype=np.int64))).sum())
        assert l[i] == lo and r[i] == lo + 4 ** (K - 5) - 1 and m[i] == 5, i
    print("GIANT-OK", int(got.max()))
    """
)


def test_wide_engine_matches_narrow():
    assert "DIFFERENTIAL-OK" in _run(_DIFFERENTIAL, timeout=600)


@pytest.mark.slow
def test_4_3_billion_column_index():
    assert "GIANT-OK" in _run(_GIANT, timeout=1800)
