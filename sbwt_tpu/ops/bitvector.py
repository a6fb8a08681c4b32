"""Packed bit vectors with word-fused rank support, device-native.

Replaces sdsl's `bit_vector` + `rank_support_v5` (the innermost primitive
of the reference query path, see SubsetMatrixRank.hh:31-37): a bit vector
becomes uint32 words interleaved with their exclusive cumulative popcount,
so a single 8-byte gather yields everything `rank(pos)` needs:

    rank(pos) = cum[pos >> 5] + popcount(word[pos >> 5] & ((1 << (pos & 31)) - 1))

Interleaving (bits, cum) per word keeps each rank query to ONE gather of
contiguous bytes: random device-memory gathers are the bottleneck of the
query loop, not popcounts.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

WORD_BITS = 32


def n_words_padded(n_bits: int) -> int:
    """Number of words including the pad word that makes rank(n) in-bounds."""
    return n_bits // WORD_BITS + 1


def pack_bits_host(bools: np.ndarray) -> np.ndarray:
    """Pack a bool array into uint32 words, LSB-first, with one pad word."""
    n = len(bools)
    W = n_words_padded(n)
    padded = np.zeros(W * WORD_BITS, dtype=bool)
    padded[:n] = bools
    b = padded.reshape(W, WORD_BITS).astype(np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    return (b << shifts).sum(axis=1, dtype=np.uint32)


def popcount_words_host(words: np.ndarray) -> np.ndarray:
    """SWAR popcount of uint32 words, int64 result."""
    v = words.copy()
    v = v - ((v >> np.uint32(1)) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> np.uint32(2)) & np.uint32(0x33333333))
    v = (v + (v >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int64)


def rank_table_from_words(words: np.ndarray) -> np.ndarray:
    """Interleaved (bits, exclusive-cum-popcount) table from packed words,
    int32 [W, 2]."""
    pops = popcount_words_host(words)
    cum = np.concatenate([[0], np.cumsum(pops)[:-1]])
    if cum[-1] + pops[-1] >= 2**31:
        raise ValueError("bit vector too large for int32 rank (>=2^31 set bits)")
    tbl = np.empty((len(words), 2), dtype=np.int32)
    tbl[:, 0] = words.view(np.int32)
    tbl[:, 1] = cum.astype(np.int32)
    return tbl


def rank_table_host(bools: np.ndarray) -> np.ndarray:
    """Build the interleaved (bits, exclusive-cum-popcount) table, int32 [W, 2]."""
    return rank_table_from_words(pack_bits_host(bools))


def rank_table_from_words_wide(
    words: np.ndarray, window: int = 1 << 24
) -> np.ndarray:
    """64-bit-rank table for bit vectors past 2^31 set bits: int32 [W, 3]
    rows (bits word, cum low 32, cum high 32).  One fused 12-byte gather
    still serves a full rank query (the narrow layout's design goal); the
    engine reassembles the int64 count on device (models/wide.py).

    Windowed with a running total: whole-row int64 popcount/cumsum
    transients would cost 8 bytes/word each — GBs at the 4.3e9-column
    scale this layout exists for."""
    W = len(words)
    tbl = np.empty((W, 3), dtype=np.int32)
    tbl[:, 0] = words.view(np.int32)
    total = np.int64(0)
    for w0 in range(0, W, window):
        w1 = min(w0 + window, W)
        pops = popcount_words_host(words[w0:w1])
        cum = np.cumsum(pops, dtype=np.int64)
        excl = np.empty(w1 - w0, dtype=np.int64)
        excl[0] = total
        excl[1:] = total + cum[:-1]
        tbl[w0:w1, 1] = (excl & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        tbl[w0:w1, 2] = (excl >> 32).astype(np.int32)
        total = total + cum[-1] if len(cum) else total
    return tbl


def unpack_bits_host(tbl: np.ndarray, n_bits: int) -> np.ndarray:
    """Recover the bool array from a rank table (host)."""
    words = tbl[:, 0].view(np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = ((words[:, None] >> shifts) & np.uint32(1)).astype(bool).ravel()
    return bits[:n_bits]


# ----------------------------------------------------------------------
# Device-side rank primitives (pure functions of the table arrays).
# ----------------------------------------------------------------------

_ONE = np.uint32(1)


def rank_from_row(row_bits: jax.Array, row_cum: jax.Array, offset: jax.Array):
    """rank within a word given its (bits, cum) row and the bit offset [0,32)."""
    word = row_bits.astype(jnp.uint32)
    mask = (_ONE << offset.astype(jnp.uint32)) - _ONE  # offset<32 so no overflow
    return row_cum + jax.lax.population_count(word & mask).astype(jnp.int32)


def rank(tbl: jax.Array, pos: jax.Array) -> jax.Array:
    """Batched rank: number of set bits strictly before pos. pos in [0, n]."""
    w = pos >> 5
    o = (pos & 31).astype(jnp.uint32)
    row = tbl[w]  # gather [..., 2]
    return rank_from_row(row[..., 0], row[..., 1], o)


def get_bit(tbl: jax.Array, pos: jax.Array) -> jax.Array:
    """Batched bit access."""
    w = pos >> 5
    o = (pos & 31).astype(jnp.uint32)
    word = tbl[w, 0].astype(jnp.uint32)
    return ((word >> o) & _ONE).astype(jnp.int32)


def rank_pair(tbl: jax.Array, pos: jax.Array):
    """(rank(pos), rank(pos+1)) from ONE row gather.

    pos+1 shares pos's (word, cum) row even at a word boundary: the
    width-(o+1) mask at o = 31 covers the whole word, and cum +
    popcount(word) equals the next row's cum by construction.  The LF
    extension step needs exactly this pair (SBWT.hh:423-437 queries
    rank at both interval ends), so pairing halves its gather count."""
    w = pos >> 5
    o = (pos & 31).astype(jnp.uint32)
    row = tbl[w]  # gather [..., 2]
    word = row[..., 0].astype(jnp.uint32)
    m1 = (_ONE << o) - _ONE
    m2 = (m1 << _ONE) | _ONE  # width o+1 <= 32 without overflowing 1<<32
    pc = jax.lax.population_count
    return (
        row[..., 1] + pc(word & m1).astype(jnp.int32),
        row[..., 1] + pc(word & m2).astype(jnp.int32),
    )


def rank_get(tbl: jax.Array, pos: jax.Array):
    """(rank(pos), bit at pos) from ONE row gather."""
    w = pos >> 5
    o = (pos & 31).astype(jnp.uint32)
    row = tbl[w]
    word = row[..., 0].astype(jnp.uint32)
    mask = (_ONE << o) - _ONE
    r = row[..., 1] + jax.lax.population_count(word & mask).astype(jnp.int32)
    return r, ((word >> o) & _ONE).astype(jnp.int32)
