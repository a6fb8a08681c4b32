"""64-bit SBWT index for pangenome-scale column counts (>= 2^31).

The reference is int64 throughout (SBWT.hh:44-46); the narrow engine
(models/matrix.py) deliberately runs int32 lanes (half the bytes per
lane of every gather index and answer) and hard-fails at 2^31 columns.
This module is the int64 path past that ceiling: positions, interval
bounds, C and the precalc table are int64, while the rank table keeps the fused
one-gather layout by splitting each word's exclusive cumulative popcount
into (low 32, high 32) halves in a contiguous int32 [., 3] row.

Requires jax x64 (`jax.config.update("jax_enable_x64", True)`); the
builders enable it.  `models.matrix.from_packed_rows` auto-routes here
when n_nodes >= 2^31.  Validated against a closed-form oracle on the
complete order-16 de Bruijn graph (4^16 + 1 = 4.29e9 columns,
tests/test_wide_index.py)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import bitvector as bv
from . import matrix

_ONE = np.uint32(1)


def _require_x64():
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rank_tbl", "sgs_tbl", "C", "precalc"],
    meta_fields=["n_nodes", "n_kmers", "k", "precalc_k", "n_words", "has_streaming"],
)
@dataclass(frozen=True)
class WideMatrixIndex:
    """Device representation of the plain-matrix SBWT with int64 ranks."""

    rank_tbl: jax.Array  # int32 [4 * n_words, 3]: (bits word, cum lo, cum hi)
    sgs_tbl: jax.Array  # int32 [n_words, 2]: (sgs word w, sgs word w-1)
    C: jax.Array  # int64 [4]
    precalc: jax.Array  # int64 [max(1, 4^p), 2]
    n_nodes: int
    n_kmers: int
    k: int
    precalc_k: int
    n_words: int
    has_streaming: bool

    pos_dtype = jnp.int64

    def _row(self, c, w):
        return self.rank_tbl[c * self.n_words + w]

    @staticmethod
    def _cum(row):
        lo = row[..., 1].astype(jnp.uint32).astype(jnp.int64)
        hi = row[..., 2].astype(jnp.int64)
        return (hi << 32) | lo

    def rank_c(self, c, pos):
        """int64 rank of character c before pos — one 12-byte gather."""
        w = pos >> 5
        o = (pos & 31).astype(jnp.uint32)
        row = self._row(c, w)
        word = row[..., 0].astype(jnp.uint32)
        mask = (_ONE << o) - _ONE
        return self._cum(row) + jax.lax.population_count(word & mask).astype(jnp.int64)

    def extend_rank(self, c, pos):
        w = pos >> 5
        o = (pos & 31).astype(jnp.uint32)
        row = self._row(c, w)
        word = row[..., 0].astype(jnp.uint32)
        mask = (_ONE << o) - _ONE
        r = self._cum(row) + jax.lax.population_count(word & mask).astype(jnp.int64)
        bit = ((word >> o) & _ONE).astype(jnp.int64)
        return r, bit

    def sg_start(self, col):
        """Suffix-group left-walk (same bounded 4-bit scan as the narrow
        engine, models/matrix.py:59-82) at int64 positions."""
        w = col >> 5
        o = (col & 31).astype(jnp.int32)
        row = self.sgs_tbl[w]
        hi = row[..., 0].astype(jnp.uint32)
        lo = row[..., 1].astype(jnp.uint32)

        def bit_at(j):
            jh = jnp.clip(j, 0, 31).astype(jnp.uint32)
            jl = jnp.clip(j + 32, 0, 31).astype(jnp.uint32)
            from_hi = (hi >> jh) & _ONE
            from_lo = (lo >> jl) & _ONE
            return jnp.where(j >= 0, from_hi, from_lo).astype(jnp.int64)

        b0 = bit_at(o)
        b1 = bit_at(o - 1)
        b2 = bit_at(o - 2)
        delta = jnp.where(b0 == 1, 0, jnp.where(b1 == 1, 1, jnp.where(b2 == 1, 2, 3)))
        return col - delta


def from_packed_rows_wide(
    row_words: np.ndarray,
    n: int,
    sgs_words: np.ndarray | None,
    k: int,
    n_kmers: int,
    precalc_k: int = 0,
    precalc_table: np.ndarray | None = None,
) -> WideMatrixIndex:
    """Build the wide index from packed uint32 rows [4, W] (W = n//32 + 1)."""
    _require_x64()
    W = n // 32 + 1
    assert row_words.shape == (4, W), (row_words.shape, W)
    # fill the fused table row-band by row-band: a concatenate of four
    # per-character tables would transiently double the 6 GB table at the
    # 4.3e9-column scale this engine exists for
    rank_tbl = np.empty((4 * W, 3), dtype=np.int32)
    for c in range(4):
        rank_tbl[c * W : (c + 1) * W] = bv.rank_table_from_words_wide(row_words[c])
    has_streaming = sgs_words is not None
    sgs_tbl = matrix.sgs_pair_table(sgs_words, W)
    C = matrix.c_array_from_rows(row_words, np.int64)

    index = WideMatrixIndex(
        rank_tbl=jnp.asarray(rank_tbl),
        sgs_tbl=jnp.asarray(sgs_tbl),
        C=jnp.asarray(C, dtype=jnp.int64),
        precalc=jnp.zeros((1, 2), dtype=jnp.int64),
        n_nodes=int(n),
        n_kmers=int(n_kmers),
        k=int(k),
        precalc_k=0,
        n_words=W,
        has_streaming=bool(has_streaming),
    )
    if precalc_table is not None:
        index = dataclasses.replace(
            index,
            precalc=jnp.asarray(precalc_table, dtype=jnp.int64),
            precalc_k=int(precalc_k),
        )
    elif precalc_k > 0:
        index = wide_with_precalc(index, precalc_k)
    return index


def wide_with_precalc(index: WideMatrixIndex, precalc_k: int) -> WideMatrixIndex:
    """Precalc table at int64 intervals (SBWT.hh:617-645 semantics)."""
    from ..ops.search import update_interval_jit

    p = int(precalc_k)
    if p == 0:
        return dataclasses.replace(
            index, precalc=jnp.zeros((1, 2), dtype=jnp.int64), precalc_k=0
        )
    if p > 13:
        raise ValueError("precalc_k > 13 not supported (table would exceed 1 GiB)")
    if p > index.k:
        raise ValueError(f"precalc_k {p} > k {index.k}")
    n_entries = 4**p
    ids = jnp.arange(n_entries, dtype=jnp.int32)
    codes = jnp.stack([(ids >> (2 * i)) & 3 for i in range(p)], axis=1)
    l0 = jnp.zeros(n_entries, dtype=jnp.int64)
    r0 = jnp.full(n_entries, index.n_nodes - 1, dtype=jnp.int64)
    l, r, alive = update_interval_jit(index, codes, l0, r0)
    tbl = jnp.stack([jnp.where(alive, l, -1), jnp.where(alive, r, -1)], axis=1)
    return dataclasses.replace(index, precalc=tbl.astype(jnp.int64), precalc_k=p)
