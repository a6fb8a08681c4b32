"""Plain-matrix SBWT index as a JAX pytree of device arrays.

Device-native re-design of the reference `SBWT<SubsetMatrixRank<...>>`
(include/sbwt/SBWT.hh:31-332, include/sbwt/SubsetMatrixRank.hh): the four
indicator bit vectors live as one flat interleaved (bits, cum-popcount)
table so that every rank query is a single contiguous 8-byte gather, and
the streaming-support bit vector is stored with each word's predecessor
word so the suffix-group left-walk (SBWT.hh:563) needs one gather.

All query engines operate on this pytree (see ops/search.py); the class is
jit-traversable (arrays are leaves, scalars are static metadata).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import bitvector as bv


_ONE = np.uint32(1)


class FusedRowEngineMixin:
    """Engine-facing interface (ops/search.py) implemented on the fused
    (bits word, cum popcount) row layout.  Requires `rank_row(c, w)` and
    `sgs_row(w)` — provided by MatrixIndex (direct gathers) and by the
    tensor-parallel view (psum-combined shard gathers, parallel/sharded.py).
    """

    # Lane position dtype for the engines; the >=2^31-column engine
    # (models/wide.py) overrides this with int64.
    pos_dtype = jnp.int32

    def rank_c(self, c, pos):
        """Count of character c in subsets 0..pos-1 (SubsetMatrixRank.hh:31-37).

        One contiguous 8-byte gather per lane."""
        w = (pos >> 5).astype(jnp.int32)
        o = (pos & 31).astype(jnp.uint32)
        row = self.rank_row(c, w)
        word = row[..., 0].astype(jnp.uint32)
        mask = (_ONE << o) - _ONE
        return row[..., 1] + jax.lax.population_count(word & mask).astype(jnp.int32)

    def extend_rank(self, c, pos):
        """(rank_c(c, pos), bit of row c at pos) from a single gather: the
        edge bit and the rank below it live in the same word row."""
        w = (pos >> 5).astype(jnp.int32)
        o = (pos & 31).astype(jnp.uint32)
        row = self.rank_row(c, w)
        word = row[..., 0].astype(jnp.uint32)
        mask = (_ONE << o) - _ONE
        r = row[..., 1] + jax.lax.population_count(word & mask).astype(jnp.int32)
        bit = ((word >> o) & _ONE).astype(jnp.int32)
        return r, bit

    def sg_start(self, col):
        """Suffix-group left-walk: greatest marked position <= col
        (SBWT.hh:563).  Suffix groups have at most 4 columns (4 possible
        preceding characters for a shared (k-1)-suffix; dummy columns are
        always marked), so the predecessor-set-bit is within 3 positions
        and always within the stored (word, previous word) pair."""
        w = (col >> 5).astype(jnp.int32)
        o = (col & 31).astype(jnp.int32)
        row = self.sgs_row(w)
        hi = row[..., 0].astype(jnp.uint32)
        lo = row[..., 1].astype(jnp.uint32)

        def bit_at(j):
            jh = jnp.clip(j, 0, 31).astype(jnp.uint32)
            jl = jnp.clip(j + 32, 0, 31).astype(jnp.uint32)
            from_hi = (hi >> jh) & _ONE
            from_lo = (lo >> jl) & _ONE
            return jnp.where(j >= 0, from_hi, from_lo).astype(jnp.int32)

        b0 = bit_at(o)
        b1 = bit_at(o - 1)
        b2 = bit_at(o - 2)
        delta = jnp.where(b0 == 1, 0, jnp.where(b1 == 1, 1, jnp.where(b2 == 1, 2, 3)))
        return col - delta


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rank_tbl", "sgs_tbl", "C", "precalc"],
    meta_fields=["n_nodes", "n_kmers", "k", "precalc_k", "n_words", "has_streaming"],
)
@dataclass(frozen=True)
class MatrixIndex(FusedRowEngineMixin):
    """Device representation of the plain-matrix SBWT."""

    rank_tbl: jax.Array  # int32 [4 * n_words, 2]: (bits word, exclusive cum popcount)
    sgs_tbl: jax.Array  # int32 [n_words, 2]: (sgs word w, sgs word w-1); empty -> [1,2] zeros
    C: jax.Array  # int32 [4] cumulative char counts, C[0] = 1
    precalc: jax.Array  # int32 [max(1, 4^p), 2] intervals of all p-length strings
    n_nodes: int
    n_kmers: int
    k: int
    precalc_k: int
    n_words: int
    has_streaming: bool

    def rank_row(self, c, w):
        """(bits word, cum) int32 row for character c, word w."""
        return self.rank_tbl[c * self.n_words + w]

    def sgs_row(self, w):
        """(sgs word w, sgs word w-1) int32 row."""
        return self.sgs_tbl[w]


def build_device_index(built, precalc_k: int = 0) -> MatrixIndex:
    """Upload a host BuiltSBWT (construct/inmemory.py) to device arrays."""
    return from_host_arrays(
        bits=built.bits,
        suffix_group_starts=built.suffix_group_starts,
        k=built.k,
        n_kmers=built.n_kmers,
        precalc_k=precalc_k,
    )


def from_host_arrays(
    bits: np.ndarray,
    suffix_group_starts: np.ndarray,
    k: int,
    n_kmers: int,
    precalc_k: int = 0,
    precalc_table: np.ndarray | None = None,
):
    n = bits.shape[1]
    if n >= 2**31:
        # Route to the int64 engine (models/wide.py) past the int32 ceiling.
        row_words = np.stack([bv.pack_bits_host(bits[c]) for c in range(4)])
        sgs_words = (
            bv.pack_bits_host(suffix_group_starts)
            if suffix_group_starts is not None and len(suffix_group_starts)
            else None
        )
        from .wide import from_packed_rows_wide

        return from_packed_rows_wide(
            row_words, n, sgs_words, k, n_kmers, precalc_k, precalc_table
        )
    tbls = [bv.rank_table_host(bits[c]) for c in range(4)]
    W = tbls[0].shape[0]
    rank_tbl = np.concatenate(tbls, axis=0)  # [4W, 2]

    has_streaming = suffix_group_starts is not None and len(suffix_group_starts) > 0
    if has_streaming:
        s_tbl = bv.rank_table_host(suffix_group_starts)
        sgs_words = s_tbl[:, 0]
        sgs_tbl = np.empty((W, 2), dtype=np.int32)
        sgs_tbl[:, 0] = sgs_words
        sgs_tbl[0, 1] = 0
        sgs_tbl[1:, 1] = sgs_words[:-1]
    else:
        sgs_tbl = np.zeros((1, 2), dtype=np.int32)

    counts = bits.sum(axis=1, dtype=np.int64)
    C = np.empty(4, dtype=np.int32)
    C[0] = 1
    C[1] = C[0] + counts[0]
    C[2] = C[1] + counts[1]
    C[3] = C[2] + counts[2]

    index = MatrixIndex(
        rank_tbl=jnp.asarray(rank_tbl),
        sgs_tbl=jnp.asarray(sgs_tbl),
        C=jnp.asarray(C),
        precalc=jnp.zeros((1, 2), dtype=jnp.int32),
        n_nodes=n,
        n_kmers=int(n_kmers),
        k=int(k),
        precalc_k=0,
        n_words=W,
        has_streaming=bool(has_streaming),
    )
    if precalc_table is not None:
        index = dataclasses.replace(
            index, precalc=jnp.asarray(precalc_table, dtype=jnp.int32), precalc_k=precalc_k
        )
    elif precalc_k > 0:
        index = with_precalc(index, precalc_k)
    return index


def sgs_pair_table(sgs_words: np.ndarray | None, W: int) -> np.ndarray:
    """(word, previous word) int32 pairs of suffix_group_starts, the
    layout the streaming left-walk gathers in one trip.  Shared by the
    narrow and wide engines — their streaming semantics must not drift."""
    if sgs_words is None:
        return np.zeros((1, 2), dtype=np.int32)
    sw = sgs_words.view(np.int32)
    tbl = np.empty((W, 2), dtype=np.int32)
    tbl[:, 0] = sw
    tbl[0, 1] = 0
    tbl[1:, 1] = sw[:-1]
    return tbl


def c_array_from_rows(row_words: np.ndarray, dtype) -> np.ndarray:
    """Cumulative count array: C[0] = 1 (ghost-dollar root edge), then
    running totals per character (SBWT.hh:344-350)."""
    counts = [int(bv.popcount_words_host(row_words[c]).sum()) for c in range(4)]
    C = np.empty(4, dtype=dtype)
    C[0] = 1
    C[1] = C[0] + counts[0]
    C[2] = C[1] + counts[1]
    C[3] = C[2] + counts[2]
    return C


def from_packed_rows(
    row_words: np.ndarray,
    n: int,
    sgs_words: np.ndarray | None,
    k: int,
    n_kmers: int,
    precalc_k: int = 0,
    precalc_table: np.ndarray | None = None,
):
    """Build a device index directly from packed uint32 rows [4, n//32+1]
    without materializing bool arrays (8 bytes/column saved — required at
    pangenome scale).  Auto-selects the int64 engine at n >= 2^31."""
    W = n // 32 + 1
    assert row_words.shape == (4, W)
    if n >= 2**31:
        from .wide import from_packed_rows_wide

        return from_packed_rows_wide(
            row_words, n, sgs_words, k, n_kmers, precalc_k, precalc_table
        )
    rank_tbl = np.concatenate(
        [bv.rank_table_from_words(row_words[c]) for c in range(4)], axis=0
    )
    has_streaming = sgs_words is not None
    sgs_tbl = sgs_pair_table(sgs_words, W)
    C = c_array_from_rows(row_words, np.int32)
    index = MatrixIndex(
        rank_tbl=jnp.asarray(rank_tbl),
        sgs_tbl=jnp.asarray(sgs_tbl),
        C=jnp.asarray(C),
        precalc=jnp.zeros((1, 2), dtype=jnp.int32),
        n_nodes=int(n),
        n_kmers=int(n_kmers),
        k=int(k),
        precalc_k=0,
        n_words=W,
        has_streaming=bool(has_streaming),
    )
    if precalc_table is not None:
        index = dataclasses.replace(
            index, precalc=jnp.asarray(precalc_table, dtype=jnp.int32), precalc_k=precalc_k
        )
    elif precalc_k > 0:
        index = with_precalc(index, precalc_k)
    return index


def with_precalc(index: MatrixIndex, precalc_k: int) -> MatrixIndex:
    """Precompute SBWT intervals of all 4^p strings (SBWT.hh:617-645).

    The table is indexed by packing characters colex-reversed:
    idx = sum_i code[i] << (2*i) (SBWT.hh:396-401).
    """
    from ..ops.search import update_interval_jit

    p = int(precalc_k)
    if p == 0:
        return dataclasses.replace(
            index, precalc=jnp.zeros((1, 2), dtype=jnp.int32), precalc_k=0
        )
    if p > 13:
        raise ValueError("precalc_k > 13 not supported (table would exceed 512 MiB)")
    if p > index.k:
        raise ValueError(f"precalc_k {p} > k {index.k}")
    base = dataclasses.replace(
        index, precalc=jnp.zeros((1, 2), dtype=jnp.int32), precalc_k=0
    )
    n_entries = 4**p
    # codes synthesized ON DEVICE: a host [4^p, p] array would be GBs of
    # upload at p >= 12.
    # Computed in bounded chunks: one 4^13-entry LF scan compiled as a
    # single program has been seen to materialize its per-step carries
    # (a 34 GB allocation at compile time on some index shapes).
    chunk = min(n_entries, 1 << 23)

    @partial(jax.jit, static_argnames=("m",))
    def _chunk(base, start, m):
        ids = start + jnp.arange(m, dtype=jnp.int32)
        codes = jnp.stack([(ids >> (2 * i)) & 3 for i in range(p)], axis=1)
        l0 = jnp.zeros(m, dtype=jnp.int32)
        r0 = jnp.full(m, index.n_nodes - 1, dtype=jnp.int32)
        from ..ops.search import update_interval_batch

        l, r, alive = update_interval_batch(base, codes, l0, r0)
        return jnp.stack(
            [jnp.where(alive, l, -1), jnp.where(alive, r, -1)], axis=1
        ).astype(jnp.int32)

    if chunk == n_entries:
        tbl = _chunk(base, 0, n_entries)
    else:
        tbl = jnp.zeros((n_entries, 2), dtype=jnp.int32)
        for s in range(0, n_entries, chunk):
            tbl = jax.lax.dynamic_update_slice(tbl, _chunk(base, s, chunk), (s, 0))
    return dataclasses.replace(index, precalc=tbl, precalc_k=p)
