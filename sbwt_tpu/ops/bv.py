"""Device-resident bit vectors with rank: plain, RRR-compressed, modified
Elias-Fano.

Device-native equivalents of the reference's three bit-vector families
(variants.hh:19-63):

* `PlainBV`    — sdsl::bit_vector + rank_support_v5: interleaved
  (word, cum-popcount) rows; rank = 1 contiguous 8-byte gather
  (ops/bitvector.py layout).
* `RRRBV`      — the rrr_vector design point (sdsl rrr_vector<> in the
  reference's rrr_* variants, variants.hh:20,27,59): blocks stored as
  (class = popcount, offset = rank among same-class patterns).  Blocks
  are 15 bits here instead of sdsl's 63 so the offset->pattern map is a
  2^15-entry LUT (128 KB): rank = one 16-byte meta row gather + two
  offset-stream word gathers + one pattern-LUT gather + a popcount.
  63-bit blocks would need a 63-iteration sequential combinatorial
  unrank per query (126 dependent binom gathers); the LUT decode trades
  ~17% extra class overhead for a table-driven decode.  Still the slow-but-small tier, as in the
  reference.  The sdsl rrr_vector<63> DISK layout is unaffected
  (io/sdsl.py has an independent codec).
* `MEFBV`      — sbwt::mod_ef_vector (MEF.hpp:85-131,376-389): buckets of
  2^wl bits; all-zero buckets dropped; `upper` marks non-empty buckets,
  `lower` concatenates kept buckets; rank = upper-rank + lower-rank =
  2 plain-rank gathers.  Bucket width chosen to minimize total bits
  (the reference reaches the same optimum by iterated pair-OR shrinking,
  MEF.hpp:284-354).

All three expose the same API:
  host:   build(bools) classmethod, to_bools(), payload()/from_payload(),
          size_in_bytes()
  device: rank(pos) batched, get(pos) batched (access; all three support
          it here — the reference's mod_ef does not, which only limits
          its ascii-export, handled at the CLI layer).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from . import bitvector as bvt

_ONE = np.uint32(1)


# ---------------------------------------------------------------------------
# Plain
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["tbl"],
    meta_fields=["n_bits"],
)
@dataclass(frozen=True)
class PlainBV:
    tbl: jax.Array  # int32 [W, 2] (bits word, exclusive cum popcount)
    n_bits: int

    @classmethod
    def build(cls, bools: np.ndarray) -> "PlainBV":
        return cls(tbl=jnp.asarray(bvt.rank_table_host(bools)), n_bits=len(bools))

    def rank(self, pos):
        return bvt.rank(self.tbl, pos)

    def rank_pair(self, pos):
        """(rank(pos), rank(pos+1)) from one row gather (bitvector.py)."""
        return bvt.rank_pair(self.tbl, pos)

    def get(self, pos):
        return bvt.get_bit(self.tbl, pos)

    def to_bools(self) -> np.ndarray:
        return bvt.unpack_bits_host(np.asarray(self.tbl), self.n_bits)

    def payload(self) -> dict:
        return {"tbl": np.asarray(self.tbl), "n_bits": np.int64(self.n_bits)}

    @classmethod
    def from_payload(cls, p: dict) -> "PlainBV":
        return cls(tbl=jnp.asarray(p["tbl"]), n_bits=int(p["n_bits"]))

    def size_in_bytes(self) -> int:
        # bits + the cum-popcount rank support (both live in tbl)
        return int(np.asarray(self.tbl).nbytes)


# ---------------------------------------------------------------------------
# RRR (block-compressed)
# ---------------------------------------------------------------------------

_BLK15 = 15  # bits per block: offset->pattern decode is a 2^15-entry LUT
_SBB15 = 16  # blocks per superblock (240 bits); 16 x 4-bit classes = 2 words

# (class, offset) <-> pattern permutation tables over all 2^15 patterns:
# offset of a pattern = its numeric rank among same-popcount patterns.
# Both encode (pattern -> offset) and decode (class base + offset ->
# pattern) are single table lookups — no combinatorial unranking.
_P15 = np.arange(1 << _BLK15, dtype=np.int64)
_CLS15 = np.zeros(1 << _BLK15, dtype=np.int64)
for _b in range(_BLK15):
    _CLS15 += (_P15 >> _b) & 1
# class_base[c] = index of the first class-c pattern in class-sorted order
_CLS_COUNT15 = np.bincount(_CLS15, minlength=_BLK15 + 1)
_CLS_BASE15 = np.zeros(_BLK15 + 2, dtype=np.int64)
_CLS_BASE15[1:] = np.cumsum(_CLS_COUNT15)
_order = np.argsort(_CLS15, kind="stable")  # patterns grouped by class, numeric within
_PATTERN15 = _order.astype(np.int32)  # LUT: class_base[c] + offset -> pattern
_OFFSET15 = np.empty(1 << _BLK15, dtype=np.int64)  # pattern -> offset within class
_OFFSET15[_order] = np.arange(1 << _BLK15, dtype=np.int64) - _CLS_BASE15[_CLS15[_order]]
# offset widths per class: ceil(log2 C(15, c)); max 13 bits
_WIDTH15 = np.array(
    [max(1, int(np.ceil(np.log2(max(1, c))))) if c > 1 else 0 for c in _CLS_COUNT15[: _BLK15 + 1]],
    dtype=np.int32,
)

_OLD_BLK = 63  # legacy round-3 payload format (63-bit blocks)
_BLK = _OLD_BLK  # back-compat alias for the legacy host codec below
_SBB = 16  # legacy blocks per superblock (1008 bits)

# C(i, j) for i in 0..62, j in 0..63 (int64 on host for exact encode;
# C(62,31) = 4.6e17 fits in 63 bits)
_BINOM = np.zeros((_BLK, _BLK + 1), dtype=np.int64)
_BINOM[:, 0] = 1
for _i in range(1, _BLK):
    _BINOM[_i, 1:] = _BINOM[_i - 1, 1:] + _BINOM[_i - 1, :-1]

# full-width binomials C(63, c) for the width table
_BINOM63 = np.zeros(_BLK + 1, dtype=np.float64)
for _c in range(_BLK + 1):
    _v = 1.0
    for _j in range(_c):
        _v = _v * (_BLK - _j) / (_j + 1)
    _BINOM63[_c] = _v

# offset width per class: ceil(log2 C(63, cls))
_WIDTHS = np.array(
    [max(0, int(np.ceil(np.log2(max(1.0, _BINOM63[c]))))) for c in range(_BLK + 1)],
    dtype=np.int32,
)


def _rrr_encode_host(bools: np.ndarray):
    """Encode to (classes uint8 [B], offsets int64 [B]) per 63-bit block."""
    n = len(bools)
    B = max(1, (n + _BLK - 1) // _BLK)
    padded = np.zeros(B * _BLK, dtype=bool)
    padded[:n] = bools
    blocks = padded.reshape(B, _BLK)
    classes = blocks.sum(axis=1).astype(np.uint8)
    # combinatorial rank: bit j = column j, scanning high position down
    offsets = np.zeros(B, dtype=np.int64)
    ones_left = classes.astype(np.int64).copy()
    for i in range(_BLK - 1, -1, -1):
        b = blocks[:, i]
        offsets[b] += _BINOM[i, ones_left[b]]
        ones_left[b] -= 1
    return classes, offsets


def _rrr_decode_host(classes: np.ndarray, offsets: np.ndarray, n_bits: int):
    B = len(classes)
    blocks = np.zeros((B, _BLK), dtype=bool)
    off = offsets.astype(np.int64).copy()
    ones_left = classes.astype(np.int64).copy()
    for i in range(_BLK - 1, -1, -1):
        c = _BINOM[i, ones_left]
        take = (off >= c) & (ones_left > 0)
        blocks[take, i] = True
        off[take] -= c[take]
        ones_left[take] -= 1
    return blocks.ravel()[:n_bits]


def _split64(v: np.ndarray):
    v = v.astype(np.uint64)
    return (v >> np.uint64(32)).astype(np.uint32), (v & np.uint64(0xFFFFFFFF)).astype(
        np.uint32
    )


# offset widths packed as nibbles into two uint32 constants (classes 0..7
# in _W15LO, 8..15 in _W15HI): width lookup is pure shift/mask
_W15LO = np.uint32(sum(int(_WIDTH15[c]) << (4 * c) for c in range(8)))
_W15HI = np.uint32(sum(int(_WIDTH15[c]) << (4 * (c - 8)) for c in range(8, 16)))


def _width15_of(cls):
    """Offset width for classes cls (int32, 0..15) — no table gather."""
    c = cls.astype(jnp.uint32) & np.uint32(7)  # clamp: both lanes compute,
    lo = _W15LO >> (4 * c)  # so the unselected one must not shift out of
    hi = _W15HI >> (4 * c)  # range (XLA leaves out-of-range shifts undefined)
    return (jnp.where(cls < 8, lo, hi) & np.uint32(15)).astype(jnp.uint32)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["meta", "offs", "lut", "base"],
    meta_fields=["n_bits"],
)
@dataclass(frozen=True)
class RRRBV:
    """RRR over 15-bit blocks: per-superblock metadata row [4 int32] =
    (cum rank, offset bit ptr, 2 words of 16x4-bit packed classes), a
    packed variable-width offset stream (offsets <= 13 bits), and the
    shared 2^15-entry offset->pattern LUT.  rank(pos) = meta row gather
    + 2 offset-word gathers + 1 LUT gather + popcount."""

    meta: jax.Array  # int32 [n_sb, 4]
    offs: jax.Array  # int32 [n_off_words] packed offset stream
    lut: jax.Array  # int32 [2^15]: class_base + offset -> 15-bit pattern
    base: jax.Array  # int32 [16]: first LUT index of each class
    n_bits: int

    @classmethod
    def build(cls, bools: np.ndarray) -> "RRRBV":
        bools = np.asarray(bools, dtype=bool)
        n = len(bools)
        B = max(1, (n + _BLK15 - 1) // _BLK15)
        padded = np.zeros(B * _BLK15, dtype=bool)
        padded[:n] = bools
        # pattern per block, bit j of a block = bit blk*15+j (LSB-first)
        pats = (
            padded.reshape(B, _BLK15).astype(np.int64)
            << np.arange(_BLK15, dtype=np.int64)
        ).sum(axis=1)
        classes = _CLS15[pats]
        offsets = _OFFSET15[pats]
        return cls._from_blocks(classes, offsets, n)

    @classmethod
    def _from_blocks(cls, classes: np.ndarray, offsets: np.ndarray, n: int) -> "RRRBV":
        B = len(classes)
        # +1 pad superblock so blk = n_bits // 15 always has a meta row
        n_sb = (B + _SBB15 - 1) // _SBB15 + 1
        cls_pad = np.zeros(n_sb * _SBB15, dtype=np.int64)
        cls_pad[:B] = classes
        widths = _WIDTH15[cls_pad].astype(np.int64)
        bit_pos = np.concatenate([[0], np.cumsum(widths)])
        total_bits = int(bit_pos[-1])
        cum = np.concatenate([[0], np.cumsum(cls_pad)]).astype(np.int64)
        if cum[-1] >= 2**31 or total_bits >= 2**31:
            raise ValueError("RRR vector too large for int32 device rank")

        # pack the (<= 13 bit) offsets; each value touches at most 2 words
        n_words = total_bits // 32 + 2
        stream = np.zeros(n_words, dtype=np.uint64)
        starts = bit_pos[: n_sb * _SBB15]
        offs64 = np.zeros(n_sb * _SBB15, dtype=np.uint64)
        offs64[:B] = offsets.astype(np.uint64)
        w = starts // 32
        sh = (starts % 32).astype(np.uint64)
        lo = (offs64 << sh) & np.uint64(0xFFFFFFFF)
        mid = np.where(sh > 0, offs64 >> (np.uint64(32) - sh), np.uint64(0))
        np.bitwise_or.at(stream, w, lo)
        np.bitwise_or.at(stream, w + 1, mid)
        offs_words = stream.astype(np.uint32).view(np.int32)

        meta = np.zeros((n_sb, 4), dtype=np.int32)
        meta[:, 0] = cum[np.arange(n_sb) * _SBB15]
        meta[:, 1] = bit_pos[np.arange(n_sb) * _SBB15]
        cls_mat = cls_pad.reshape(n_sb, _SBB15)
        packed = np.zeros((n_sb, 2), dtype=np.uint64)
        for j in range(_SBB15):
            packed[:, j // 8] |= cls_mat[:, j].astype(np.uint64) << np.uint64(4 * (j % 8))
        meta[:, 2:4] = (packed & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        return cls(
            meta=jnp.asarray(meta),
            offs=jnp.asarray(offs_words),
            lut=jnp.asarray(_PATTERN15),
            base=jnp.asarray(_CLS_BASE15[:16], dtype=jnp.int32),
            n_bits=n,
        )

    # ---- device ----

    def _pattern_at(self, pos):
        """(pattern uint32 of the containing block, in-block offset o,
        rank before the block) — the shared path of rank and get."""
        blk = pos // _BLK15
        sb = blk >> 4
        j = blk & 15
        row = self.meta[sb]  # [..., 4] one 16-byte gather
        cum0 = row[..., 0]
        optr = row[..., 1]
        w0c = row[..., 2].astype(jnp.uint32)
        w1c = row[..., 3].astype(jnp.uint32)
        # unpack 16 4-bit classes: pure shifts, no gathers
        six = jnp.stack(
            [(w0c >> np.uint32(4 * t)) & np.uint32(15) for t in range(8)]
            + [(w1c >> np.uint32(4 * t)) & np.uint32(15) for t in range(8)],
            axis=-1,
        ).astype(jnp.int32)  # [..., 16]
        mask = jnp.arange(_SBB15, dtype=jnp.int32) < j[..., None]
        cls_sum = jnp.sum(jnp.where(mask, six, 0), axis=-1)
        my_cls = jnp.take_along_axis(six, (j & 15)[..., None], axis=-1)[..., 0]
        w_sum = jnp.sum(
            jnp.where(mask, _width15_of(six).astype(jnp.int32), 0), axis=-1
        )
        bitp = optr + w_sum
        wi = bitp >> 5
        sh = (bitp & 31).astype(jnp.uint32)
        s0 = self.offs[wi].astype(jnp.uint32)
        s1 = self.offs[wi + 1].astype(jnp.uint32)
        raw = (s0 >> sh) | jnp.where(sh > 0, s1 << (np.uint32(32) - sh), np.uint32(0))
        width = _width15_of(my_cls)
        off = (raw & ((_ONE << width) - _ONE)).astype(jnp.int32)
        pat = self.lut[self.base[my_cls] + off].astype(jnp.uint32)
        o = pos - blk * _BLK15
        return pat, o, cum0 + cls_sum

    def rank(self, pos):
        pos = jnp.asarray(pos, dtype=jnp.int32)
        pat, o, before = self._pattern_at(pos)
        inblock = jax.lax.population_count(
            pat & ((_ONE << o.astype(jnp.uint32)) - _ONE)
        ).astype(jnp.int32)
        return before + inblock

    def rank_pair(self, pos):
        """(rank(pos), rank(pos+1)) from ONE decode chain: pos+1 shares
        pos's 15-bit block (the width-(o+1) mask at o = 14 covers the
        whole pattern, whose popcount + `before` equals the next block's
        prefix rank).  The LF extension step queries exactly this pair,
        so pairing halves the rrr gather count per step — the round-4
        rrr cell ran TWO full 4-gather chains per extension."""
        pos = jnp.asarray(pos, dtype=jnp.int32)
        pat, o, before = self._pattern_at(pos)
        m1 = (_ONE << o.astype(jnp.uint32)) - _ONE
        m2 = (m1 << _ONE) | _ONE  # width o+1 <= 15
        pc = jax.lax.population_count
        return (
            before + pc(pat & m1).astype(jnp.int32),
            before + pc(pat & m2).astype(jnp.int32),
        )

    def get(self, pos):
        pos = jnp.asarray(pos, dtype=jnp.int32)
        pat, o, _ = self._pattern_at(pos)
        return ((pat >> o.astype(jnp.uint32)) & _ONE).astype(jnp.int32)

    # ---- host ----

    def _host_blocks(self):
        """(classes int64 [n_sb*16], offsets int64 [n_sb*16]) decoded from
        the device arrays with vectorized numpy."""
        meta = np.asarray(self.meta)
        n_sb = meta.shape[0]
        cls_words = (
            np.ascontiguousarray(meta[:, 2:4]).view(np.uint32).reshape(n_sb, 2).astype(np.uint64)
        )
        classes = np.zeros((n_sb, _SBB15), dtype=np.int64)
        for j in range(_SBB15):
            classes[:, j] = (cls_words[:, j // 8] >> np.uint64(4 * (j % 8))) & 15
        classes = classes.ravel()
        widths = _WIDTH15[classes].astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(widths)])[:-1]
        stream = np.asarray(self.offs).view(np.uint32).astype(np.uint64)
        stream = np.concatenate([stream, np.zeros(2, dtype=np.uint64)])
        wi = starts // 32
        sh = (starts % 32).astype(np.uint64)
        raw = (stream[wi] >> sh) | np.where(
            sh > 0, stream[wi + 1] << (np.uint64(32) - sh), np.uint64(0)
        )
        offsets = (raw & ((np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1))).astype(
            np.int64
        )
        return classes, offsets

    def to_bools(self) -> np.ndarray:
        classes, offsets = self._host_blocks()
        n_blocks = max(1, (self.n_bits + _BLK15 - 1) // _BLK15)
        pats = _PATTERN15[_CLS_BASE15[classes[:n_blocks]] + offsets[:n_blocks]]
        bits = (pats[:, None] >> np.arange(_BLK15, dtype=np.int64)) & 1
        return bits.astype(bool).ravel()[: self.n_bits]

    def payload(self) -> dict:
        return {
            "meta15": np.asarray(self.meta),
            "offs15": np.asarray(self.offs),
            "n_bits": np.int64(self.n_bits),
        }

    @classmethod
    def from_payload(cls, p: dict) -> "RRRBV":
        if "meta15" in p:
            return cls(
                meta=jnp.asarray(p["meta15"]),
                offs=jnp.asarray(p["offs15"]),
                lut=jnp.asarray(_PATTERN15),
                base=jnp.asarray(_CLS_BASE15[:16], dtype=jnp.int32),
                n_bits=int(p["n_bits"]),
            )
        # legacy round-3 payload: 63-bit blocks; decode and re-block
        return cls.build(_legacy_rrr63_to_bools(p))

    def size_in_bytes(self) -> int:
        # the 128 KB pattern LUT is a shared module constant (like sdsl's
        # static binomial helper tables) and is not per-vector payload
        return int(np.asarray(self.meta).nbytes + np.asarray(self.offs).nbytes)


def _legacy_rrr63_to_bools(p: dict) -> np.ndarray:
    """Decode a round-3 63-bit-block RRR payload {meta, offs, n_bits}."""
    meta = np.asarray(p["meta"])
    n_bits = int(p["n_bits"])
    n_sb = meta.shape[0]
    cls_words = (
        np.ascontiguousarray(meta[:, 2:5]).view(np.uint32).reshape(n_sb, 3).astype(np.uint64)
    )
    classes = np.zeros((n_sb, _SBB), dtype=np.int64)
    for j in range(_SBB):
        word = (j * 6) // 32
        shift = (j * 6) % 32
        v = cls_words[:, word] >> np.uint64(shift)
        if shift > 26:
            v |= cls_words[:, min(word + 1, 2)] << np.uint64(32 - shift)
        classes[:, j] = v & 63
    classes = classes.ravel()
    widths = _WIDTHS[classes].astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(widths)])[:-1]
    stream = np.asarray(p["offs"]).view(np.uint32).astype(np.uint64)
    stream = np.concatenate([stream, np.zeros(3, dtype=np.uint64)])
    wi = starts // 32
    sh = (starts % 32).astype(np.uint64)
    w0 = stream[wi]
    w1 = stream[wi + 1]
    w2 = stream[wi + 2]
    inv = np.uint64(32) - sh
    lo = (w0 >> sh) | np.where(sh > 0, w1 << inv, np.uint64(0))
    lo &= np.uint64(0xFFFFFFFF)
    hi = np.where(sh > 0, (w1 >> sh) | ((w2 << inv) & np.uint64(0xFFFFFFFF)), w1)
    hi &= np.uint64(0xFFFFFFFF)
    raw = lo | (hi << np.uint64(32))
    masks = np.where(
        widths >= 64,
        np.uint64(0xFFFFFFFFFFFFFFFF),
        (np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1),
    )
    offsets = (raw & masks).astype(np.int64)
    n_blocks = max(1, (n_bits + _BLK - 1) // _BLK)
    return _rrr_decode_host(
        classes[:n_blocks].astype(np.uint8), offsets[:n_blocks], n_bits
    )


# ---------------------------------------------------------------------------
# Modified Elias-Fano
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["upper", "lower"],
    meta_fields=["n_bits", "wl"],
)
@dataclass(frozen=True)
class MEFBV:
    """mod_ef_vector: non-empty 2^wl-bit buckets kept in `lower`,
    `upper` marks which buckets were kept (MEF.hpp:85-131).

    rank(pos) (MEF.hpp:376-389): with b = pos >> wl and
    u = rank1(upper, b), the answer is rank1(lower, (u << wl) + t) where
    t = pos & (2^wl - 1) if bucket b is non-empty else 0 — two plain
    rank gathers."""

    upper: PlainBV
    lower: PlainBV
    n_bits: int
    wl: int

    @classmethod
    def build(cls, bools: np.ndarray, wl: int | None = None) -> "MEFBV":
        bools = np.asarray(bools, dtype=bool)
        n = len(bools)
        if wl is None:
            wl = _best_mef_width(bools)
        bs = 1 << wl
        n_buckets = max(1, (n + bs - 1) // bs)
        padded = np.zeros(n_buckets * bs, dtype=bool)
        padded[:n] = bools
        buckets = padded.reshape(n_buckets, bs)
        nonempty = buckets.any(axis=1)
        lower_bits = buckets[nonempty].ravel()
        return cls(
            upper=PlainBV.build(nonempty),
            lower=PlainBV.build(lower_bits),
            n_bits=n,
            wl=int(wl),
        )

    def rank(self, pos):
        pos = jnp.asarray(pos, dtype=jnp.int32)
        b = pos >> self.wl
        t = pos & ((1 << self.wl) - 1)
        # upper rank + bit come from the same (word, cum) row: one gather
        u, keep = bvt.rank_get(self.upper.tbl, b)
        lpos = (u << self.wl) + jnp.where(keep == 1, t, 0)
        return self.lower.rank(lpos)

    def rank_pair(self, pos):
        """(rank(pos), rank(pos+1)) in 2 gathers (vs 4-6 for two ranks).

        rank(pos+1) - rank(pos) is the bit at pos, which is 0 unless
        bucket b is kept, in which case it is lower's bit at lpos — so
        lower.rank_pair(lpos) serves both, including the bucket-crossing
        case (t = 2^wl - 1: the next bucket's lpos is either lpos + 1
        when b is kept, or lpos itself when it is not)."""
        pos = jnp.asarray(pos, dtype=jnp.int32)
        b = pos >> self.wl
        t = pos & ((1 << self.wl) - 1)
        u, keep = bvt.rank_get(self.upper.tbl, b)
        lpos = (u << self.wl) + jnp.where(keep == 1, t, 0)
        r1, r2 = self.lower.rank_pair(lpos)
        return r1, jnp.where(keep == 1, r2, r1)

    def get(self, pos):
        pos = jnp.asarray(pos, dtype=jnp.int32)
        b = pos >> self.wl
        t = pos & ((1 << self.wl) - 1)
        u = self.upper.rank(b)
        keep = self.upper.get(b)
        bit = self.lower.get((u << self.wl) + t)
        return jnp.where(keep == 1, bit, 0)

    def to_bools(self) -> np.ndarray:
        up = self.upper.to_bools()
        low = self.lower.to_bools()
        bs = 1 << self.wl
        n_buckets = len(up)
        out = np.zeros(n_buckets * bs, dtype=bool)
        kept = np.flatnonzero(up)
        low = low[: len(kept) * bs].reshape(len(kept), bs)
        out.reshape(n_buckets, bs)[kept] = low
        return out[: self.n_bits]

    def payload(self) -> dict:
        return {
            "upper_tbl": np.asarray(self.upper.tbl),
            "upper_n": np.int64(self.upper.n_bits),
            "lower_tbl": np.asarray(self.lower.tbl),
            "lower_n": np.int64(self.lower.n_bits),
            "n_bits": np.int64(self.n_bits),
            "wl": np.int64(self.wl),
        }

    @classmethod
    def from_payload(cls, p: dict) -> "MEFBV":
        return cls(
            upper=PlainBV(tbl=jnp.asarray(p["upper_tbl"]), n_bits=int(p["upper_n"])),
            lower=PlainBV(tbl=jnp.asarray(p["lower_tbl"]), n_bits=int(p["lower_n"])),
            n_bits=int(p["n_bits"]),
            wl=int(p["wl"]),
        )

    def size_in_bytes(self) -> int:
        return self.upper.size_in_bytes() + self.lower.size_in_bytes()


def _best_mef_width(bools: np.ndarray) -> int:
    """Bucket width minimizing total stored bits (upper + lower).

    The reference reaches the same optimum by iterated pair-OR shrink
    (MEF.hpp:284-354); direct evaluation gives the identical answer."""
    n = len(bools)
    if n == 0:
        return 3
    best_wl, best_cost = 3, None
    for wl in range(3, 17):
        bs = 1 << wl
        n_buckets = (n + bs - 1) // bs
        padded = np.zeros(n_buckets * bs, dtype=bool)
        padded[:n] = bools
        nonempty = int(padded.reshape(n_buckets, bs).any(axis=1).sum())
        cost = n_buckets + nonempty * bs
        if best_cost is None or cost < best_cost:
            best_wl, best_cost = wl, cost
        if bs >= n:
            break
    return best_wl


BV_CLASSES = {"plain": PlainBV, "rrr": RRRBV, "mef": MEFBV}
