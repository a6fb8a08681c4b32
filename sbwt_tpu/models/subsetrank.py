"""Subset-rank structures: the L1 layer of the index, one per variant family.

Device-native equivalents of the reference's four structure families
(SURVEY.md §2.2), each a JAX pytree with batched device `rank(c, pos)`
(count of character c in subsets 0..pos-1, SubsetMatrixRank.hh:30-37):

* `MatrixRank`   — SubsetMatrixRank.hh: the 4 indicator rows concatenated
  char-major into ONE bit vector (plain / rrr / mef), so rank(c, pos) =
  BV.rank(c*n + pos) − base[c] = a single BV rank of the chosen kind.
* `SplitRank`    — SubsetSplitRank.hh:90-141,173-184: X marks columns with
  ≠1 out-edge; unary column labels go to a 4-symbol wavelet tree Y; other
  columns' rows go to dense Z (concatenated char-major);
  rank(c,pos) = Y.rank(c, pos − X.rank(pos)) + Z_c.rank(X.rank(pos)).
* `ConcatRank`   — SubsetConcatRank.hh:36-65: all set elements concatenated
  over {$,A,C,G,T} ('$' = empty set) into a 5-symbol wavelet tree; the L
  bit vector (0 at each set start, end sentinel) gives set boundaries;
  rank(c,pos) = WT.rank(c, L.select0(pos+1)).  select0 is sampled every
  8th zero + a 64-bit window scan (set sizes are ≤ 4, so 8 zeros always
  fit in the window).
* `SubsetWTRank` — SubsetWT.hh:41-113: three 4-symbol wavelet trees
  (ACGT / AC / GT) over (left-presence, right-presence) pair symbols;
  rank uses subtree-rank shortcuts so A costs 2 bit-vector ranks and T at
  most 6 (the reference pays 8 sdsl ranks for every character).

All structures support host `from_bits` / `to_bits` / `payload` round
trips; `to_bits` restores the plain matrix for host tooling (superset of
the reference, whose mod_ef variants cannot access bits).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.bv import BV_CLASSES, PlainBV
from ..ops.wavelet import WaveletTree

_ONE32 = np.uint32(1)


def _pack_width_u32(vals: np.ndarray, width: int) -> np.ndarray:
    """Pack width-bit values into a little-endian uint32 word stream."""
    bits = ((vals[:, None] >> np.arange(width, dtype=np.int64)) & 1).astype(np.uint8)
    flat = bits.ravel()
    pad = (-len(flat)) % 32
    flat = np.concatenate([flat, np.zeros(pad, dtype=np.uint8)])
    return np.packbits(flat, bitorder="little").view(np.uint32).copy()


def _unpack_width_u32(words: np.ndarray, width: int, count: int) -> np.ndarray:
    bits = np.unpackbits(
        np.ascontiguousarray(words, dtype=np.uint32).view(np.uint8), bitorder="little"
    )[: count * width].reshape(count, width)
    return (bits.astype(np.int64) << np.arange(width, dtype=np.int64)).sum(axis=1)


def _concat_rows_build(bits: np.ndarray, kind: str):
    """One BV over char-major concatenated rows + per-char base ranks."""
    flat = np.concatenate([bits[c] for c in range(4)])
    bv = BV_CLASSES[kind].build(flat)
    counts = bits.sum(axis=1, dtype=np.int64)
    base = np.zeros(5, dtype=np.int32)
    base[1:] = np.cumsum(counts)
    return bv, base


# ---------------------------------------------------------------------------
# Matrix
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["bv", "base"],
    meta_fields=["n", "kind"],
)
@dataclass(frozen=True)
class MatrixRank:
    bv: object  # BV over [A_bits | C_bits | G_bits | T_bits], length 4n
    base: jax.Array  # int32 [5] rank at the start of each char block
    n: int
    kind: str

    @classmethod
    def from_bits(cls, bits: np.ndarray, kind: str) -> "MatrixRank":
        bv, base = _concat_rows_build(bits, kind)
        return cls(bv=bv, base=jnp.asarray(base), n=bits.shape[1], kind=kind)

    def rank(self, c, pos):
        c = jnp.asarray(c, dtype=jnp.int32)
        pos = jnp.asarray(pos, dtype=jnp.int32)
        return self.bv.rank(c * self.n + pos) - self.base[c]

    def rank_pair(self, c, pos):
        """(rank(c,pos), rank(c,pos+1)) at the gather cost of ONE rank
        (the LF extension pair — both land in the same block of the
        underlying bit vector)."""
        c = jnp.asarray(c, dtype=jnp.int32)
        pos = jnp.asarray(pos, dtype=jnp.int32)
        r1, r2 = self.bv.rank_pair(c * self.n + pos)
        return r1 - self.base[c], r2 - self.base[c]

    def contains(self, c, pos):
        return self.bv.get(jnp.asarray(c, jnp.int32) * self.n + jnp.asarray(pos, jnp.int32))

    def to_bits(self) -> np.ndarray:
        flat = self.bv.to_bools()
        return flat.reshape(4, self.n)

    def payload(self) -> dict:
        out = {"n": np.int64(self.n), "base": np.asarray(self.base)}
        for k, v in self.bv.payload().items():
            out[f"bv_{k}"] = v
        return out

    @classmethod
    def from_payload(cls, p: dict, kind: str) -> "MatrixRank":
        sub = {k[3:]: v for k, v in p.items() if k.startswith("bv_")}
        bv = BV_CLASSES[kind].from_payload(sub)
        n = int(p["n"])
        if "base" in p:
            base = np.asarray(p["base"], dtype=np.int32)
        else:
            # legacy payloads (pre round 4) lack the 5-int base array and
            # must pay an O(n) bool decode of the compressed vector
            bits = bv.to_bools().reshape(4, n)
            counts = bits.sum(axis=1, dtype=np.int64)
            base = np.zeros(5, dtype=np.int32)
            base[1:] = np.cumsum(counts)
        return cls(bv=bv, base=jnp.asarray(base), n=n, kind=kind)

    def size_in_bytes(self) -> int:
        return self.bv.size_in_bytes()


# ---------------------------------------------------------------------------
# Split
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["X", "Y", "Z", "z_base"],
    meta_fields=["n", "n_b", "x_kind", "z_kind"],
)
@dataclass(frozen=True)
class SplitRank:
    X: object  # BV over n: 1 = column has != 1 out-edge
    Y: WaveletTree  # sigma=4 over unary column labels
    Z: object  # BV over 4*n_b: char-major rows of branching columns
    z_base: jax.Array  # int32 [5]
    n: int
    n_b: int
    x_kind: str
    z_kind: str

    @classmethod
    def from_bits(cls, bits: np.ndarray, x_kind: str, z_kind: str) -> "SplitRank":
        sizes = bits.sum(axis=0)
        unary = sizes == 1
        X_bools = ~unary
        y_syms = np.argmax(bits[:, unary], axis=0) if unary.any() else np.empty(0, dtype=np.int64)
        zbits = bits[:, X_bools]
        Z, z_base = _concat_rows_build(zbits, z_kind)
        return cls(
            X=BV_CLASSES[x_kind].build(X_bools),
            Y=WaveletTree.build(y_syms, 4, "plain"),
            Z=Z,
            z_base=jnp.asarray(z_base),
            n=bits.shape[1],
            n_b=int(X_bools.sum()),
            x_kind=x_kind,
            z_kind=z_kind,
        )

    def rank(self, c, pos):
        c = jnp.asarray(c, dtype=jnp.int32)
        pos = jnp.asarray(pos, dtype=jnp.int32)
        xr = self.X.rank(pos)
        yr = self.Y.rank(c, pos - xr)
        zr = self.Z.rank(c * self.n_b + xr) - self.z_base[c]
        return yr + zr

    def rank_pair(self, c, pos):
        """(rank(c,pos), rank(c,pos+1)) at the gather cost of ~one rank:
        pos+1's X/Y/Z arguments are each pos's argument or its +1
        neighbor (X's bit at pos routes the +1 into exactly one of the
        unary (Y) or branching (Z) sides), so the component rank_pairs
        serve both."""
        c = jnp.asarray(c, dtype=jnp.int32)
        pos = jnp.asarray(pos, dtype=jnp.int32)
        xr1, xr2 = self.X.rank_pair(pos)
        xbit = xr2 - xr1  # 1 iff pos is a branching column
        y1, y2 = self.Y.rank_pair(c, pos - xr1)
        z1, z2 = self.Z.rank_pair(c * self.n_b + xr1)
        r1 = y1 + z1 - self.z_base[c]
        # branching pos: Y argument unchanged, Z argument advances;
        # unary pos: Y argument advances, Z argument unchanged
        r2 = jnp.where(xbit == 1, y1 + z2, y2 + z1) - self.z_base[c]
        return r1, r2

    def contains(self, c, pos):
        return self.rank(c, pos + 1) - self.rank(c, pos)

    def to_bits(self) -> np.ndarray:
        X_bools = self.X.to_bools()
        y_syms = self.Y.to_symbols()
        zflat = self.Z.to_bools().reshape(4, self.n_b)
        bits = np.zeros((4, self.n), dtype=bool)
        un = np.flatnonzero(~X_bools)
        bits[y_syms, un] = True
        br = np.flatnonzero(X_bools)
        bits[:, br] = zflat
        return bits

    def payload(self) -> dict:
        out = {
            "n": np.int64(self.n),
            "n_b": np.int64(self.n_b),
            "z_base": np.asarray(self.z_base),
        }
        for k, v in self.X.payload().items():
            out[f"X_{k}"] = v
        for k, v in self.Y.payload().items():
            out[f"Y_{k}"] = v
        for k, v in self.Z.payload().items():
            out[f"Z_{k}"] = v
        return out

    @classmethod
    def from_payload(cls, p: dict, x_kind: str, z_kind: str) -> "SplitRank":
        X = BV_CLASSES[x_kind].from_payload(
            {k[2:]: v for k, v in p.items() if k.startswith("X_")}
        )
        Y = WaveletTree.from_payload(
            {k[2:]: v for k, v in p.items() if k.startswith("Y_")}, "plain"
        )
        Z = BV_CLASSES[z_kind].from_payload(
            {k[2:]: v for k, v in p.items() if k.startswith("Z_")}
        )
        n_b = int(p["n_b"])
        if "z_base" in p:
            z_base = np.asarray(p["z_base"], dtype=np.int32)
        else:
            # legacy payloads: recompute by decoding (O(n) bools)
            zbits = Z.to_bools().reshape(4, n_b)
            counts = zbits.sum(axis=1, dtype=np.int64)
            z_base = np.zeros(5, dtype=np.int32)
            z_base[1:] = np.cumsum(counts)
        return cls(
            X=X, Y=Y, Z=Z, z_base=jnp.asarray(z_base),
            n=int(p["n"]), n_b=n_b, x_kind=x_kind, z_kind=z_kind,
        )

    def size_in_bytes(self) -> int:
        return self.X.size_in_bytes() + self.Y.size_in_bytes() + self.Z.size_in_bytes()


# ---------------------------------------------------------------------------
# Concat
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["wt", "l_words", "samples"],
    meta_fields=["n", "wt_kind"],
)
@dataclass(frozen=True)
class ConcatRank:
    wt: WaveletTree  # sigma=5: 0='$', 1..4 = A,C,G,T
    l_words: jax.Array  # int32 [W, 2]: (L word w, L word w+1) for window scans
    samples: jax.Array  # int32: position of every 8th zero of L
    n: int
    wt_kind: str

    @classmethod
    def from_bits(cls, bits: np.ndarray, wt_kind: str) -> "ConcatRank":
        n = bits.shape[1]
        sizes = bits.sum(axis=0)
        sizes_eff = np.maximum(sizes, 1)  # empty set emits '$'
        total = int(sizes_eff.sum())
        # concat symbols, column-major within each set in A,C,G,T order
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(sizes_eff, out=starts[1:])
        syms = np.zeros(total, dtype=np.int64)
        offs = starts[:-1].copy()
        for c in range(4):
            idx = np.flatnonzero(bits[c])
            syms[offs[idx]] = c + 1
            offs[idx] += 1
        # empty sets keep symbol 0 ('$')
        # L: 0 at each set start, 1 elsewhere, plus end sentinel 0
        L = np.ones(total + 1, dtype=bool)
        L[starts[:-1]] = False
        L[total] = False
        l_words, samples = cls._scan_structs(L, total)
        return cls(
            wt=WaveletTree.build(syms, 5, wt_kind),
            l_words=jnp.asarray(l_words),
            samples=jnp.asarray(samples),
            n=n,
            wt_kind=wt_kind,
        )

    def _select0(self, i):
        """Position of the (i+1)-th zero of L (0-based i-th), batched."""
        s = self.samples[i >> 3]
        rem = (i & 7).astype(jnp.int32)
        row = self.l_words[s >> 5]
        w0 = row[..., 0].astype(jnp.uint32)
        w1 = row[..., 1].astype(jnp.uint32)
        o = (s & 31).astype(jnp.uint32)
        # 64-bit zero mask starting at bit o of w0
        z0 = ~w0
        z1 = ~w1
        lo = (z0 >> o) | jnp.where(o > 0, z1 << (np.uint32(32) - o), np.uint32(0))
        hi = jnp.where(o > 0, z1 >> o, np.uint32(0))
        # find position of the rem-th set bit in (hi:lo) via 6-step binary
        # search on prefix popcounts
        target = rem + 1
        pos = jnp.zeros_like(rem)
        width = 32
        cnt_lo = jax.lax.population_count(lo).astype(jnp.int32)
        use_hi = cnt_lo < target
        word = jnp.where(use_hi, hi, lo)
        target = jnp.where(use_hi, target - cnt_lo, target)
        base = jnp.where(use_hi, 32, 0)
        for shift in [16, 8, 4, 2, 1]:
            mask = (_ONE32 << np.uint32(shift)) - _ONE32
            low = word & mask
            c = jax.lax.population_count(low).astype(jnp.int32)
            go_hi = c < target
            word = jnp.where(go_hi, word >> np.uint32(shift), low)
            target = jnp.where(go_hi, target - c, target)
            base = base + jnp.where(go_hi, shift, 0)
        return s + base

    def rank(self, c, pos):
        c = jnp.asarray(c, dtype=jnp.int32)
        pos = jnp.asarray(pos, dtype=jnp.int32)
        start = self._select0(pos)
        return self.wt.rank(c + 1, start)

    def _select0_pair(self, i):
        """Positions of the (i+1)-th AND (i+2)-th zeros of L from ONE
        sampled 64-bit window: sets hold <= 4 symbols, so zeros i..i+9
        from the every-8th sample span <= 36 bits — both answers always
        sit inside the window, and the second binary search is pure elementwise
        (no extra gathers)."""
        s = self.samples[i >> 3]
        rem = (i & 7).astype(jnp.int32)
        row = self.l_words[s >> 5]
        w0 = row[..., 0].astype(jnp.uint32)
        w1 = row[..., 1].astype(jnp.uint32)
        o = (s & 31).astype(jnp.uint32)
        z0 = ~w0
        z1 = ~w1
        lo = (z0 >> o) | jnp.where(o > 0, z1 << (np.uint32(32) - o), np.uint32(0))
        hi = jnp.where(o > 0, z1 >> o, np.uint32(0))
        outs = []
        cnt_lo = jax.lax.population_count(lo).astype(jnp.int32)
        for extra in (1, 2):
            target = rem + extra
            use_hi = cnt_lo < target
            word = jnp.where(use_hi, hi, lo)
            t = jnp.where(use_hi, target - cnt_lo, target)
            base = jnp.where(use_hi, 32, 0)
            for shift in [16, 8, 4, 2, 1]:
                mask = (_ONE32 << np.uint32(shift)) - _ONE32
                low = word & mask
                cc = jax.lax.population_count(low).astype(jnp.int32)
                go_hi = cc < t
                word = jnp.where(go_hi, word >> np.uint32(shift), low)
                t = jnp.where(go_hi, t - cc, t)
                base = base + jnp.where(go_hi, shift, 0)
            outs.append(s + base)
        return outs[0], outs[1]

    def rank_pair(self, c, pos):
        """(rank(c,pos), rank(c,pos+1)) — the LF extension pair.  Saves
        the second select0's gathers (sample + window row); the two
        wavelet ranks stay separate because consecutive set starts are
        up to 4 symbols apart."""
        c = jnp.asarray(c, dtype=jnp.int32)
        pos = jnp.asarray(pos, dtype=jnp.int32)
        s1, s2 = self._select0_pair(pos)
        return self.wt.rank(c + 1, s1), self.wt.rank(c + 1, s2)

    def contains(self, c, pos):
        return self.rank(c, pos + 1) - self.rank(c, pos)

    def to_bits(self) -> np.ndarray:
        syms = self.wt.to_symbols()
        samples = np.asarray(self.samples)
        # set starts from zeros of L: reconstruct zeros by scanning words
        words = np.ascontiguousarray(np.asarray(self.l_words)[:, 0]).view(np.uint32)
        bools = np.unpackbits(
            words.view(np.uint8), bitorder="little"
        )[: len(syms) + 1].astype(bool)
        starts = np.flatnonzero(~bools)[:-1]  # drop end sentinel
        n = self.n
        bits = np.zeros((4, n), dtype=bool)
        col = np.zeros(len(syms), dtype=np.int64)
        col[starts] = 1
        col = np.cumsum(col) - 1
        nz = syms > 0
        bits[syms[nz] - 1, col[nz]] = True
        return bits

    def payload(self) -> dict:
        out = {"n": np.int64(self.n)}
        if self.wt_kind == "rrr":
            # mef-concat stores L compressed on disk as Elias-Fano over the
            # zero (set-boundary) positions — the sd_vector design point of
            # the reference's mef_concat_sbwt_t (variants.hh:43-49).  The
            # device scan structures (window words + select0 samples) are
            # derived, and rebuilt on load like sdsl supports are.
            words = np.ascontiguousarray(np.asarray(self.l_words)[:, 0]).view(np.uint32)
            total = int(self.wt.n)
            L = np.unpackbits(words.view(np.uint8), bitorder="little")[: total + 1].astype(bool)
            zeros = np.flatnonzero(~L).astype(np.int64)
            m = len(zeros)
            wl = max(0, int(np.floor(np.log2(max(1, (total + 1) // m))))) if m else 0
            low = zeros & ((1 << wl) - 1)
            upper_len = m + ((total + 1) >> wl) + 1
            upper = np.zeros(upper_len, dtype=bool)
            upper[(zeros >> wl) + np.arange(m)] = True
            out["L_ef_upper"] = np.packbits(upper, bitorder="little")
            out["L_ef_low"] = (
                np.zeros(0, dtype=np.uint32) if wl == 0 else _pack_width_u32(low, wl)
            )
            out["L_ef_meta"] = np.array([wl, m, total, upper_len], dtype=np.int64)
        else:
            out["l_words"] = np.asarray(self.l_words)[:, 0]  # col 1 is derived
            out["samples"] = np.asarray(self.samples)
        for k, v in self.wt.payload().items():
            out[f"wt_{k}"] = v
        return out

    @classmethod
    def from_payload(cls, p: dict, wt_kind: str) -> "ConcatRank":
        wt = WaveletTree.from_payload(
            {k[3:]: v for k, v in p.items() if k.startswith("wt_")}, wt_kind
        )
        if "L_ef_meta" in p:
            wl, m, total, upper_len = [int(x) for x in np.asarray(p["L_ef_meta"])]
            upper = np.unpackbits(
                np.asarray(p["L_ef_upper"], dtype=np.uint8), bitorder="little"
            )[:upper_len].astype(bool)
            low = (
                np.zeros(m, dtype=np.int64)
                if wl == 0
                else _unpack_width_u32(np.asarray(p["L_ef_low"]), wl, m)
            )
            zeros = ((np.flatnonzero(upper) - np.arange(m)) << wl) | low
            L = np.ones(total + 1, dtype=bool)
            L[zeros] = False
            l_words, samples = cls._scan_structs(L, total)
        else:
            w0 = np.asarray(p["l_words"], dtype=np.int32)
            l_words = np.zeros((len(w0), 2), dtype=np.int32)
            l_words[:, 0] = w0
            l_words[:-1, 1] = w0[1:]
            samples = np.asarray(p["samples"], dtype=np.int32)
        return cls(
            wt=wt,
            l_words=jnp.asarray(l_words),
            samples=jnp.asarray(samples),
            n=int(p["n"]),
            wt_kind=wt_kind,
        )

    @staticmethod
    def _scan_structs(L: np.ndarray, total: int):
        """Derive the device window words + select0 samples from L bools."""
        W = total // 32 + 2
        padded = np.zeros(W * 32, dtype=bool)
        padded[: total + 1] = L
        words = np.packbits(padded.reshape(W, 32), axis=1, bitorder="little")
        words = words.view(np.uint32).ravel().astype(np.uint32)
        l_words = np.zeros((W, 2), dtype=np.int32)
        l_words[:, 0] = words.view(np.int32)
        l_words[:-1, 1] = words[1:].view(np.int32)
        samples = np.flatnonzero(~L)[::8].astype(np.int32)
        return l_words, samples

    def size_in_bytes(self) -> int:
        return (
            self.wt.size_in_bytes()
            + int(np.asarray(self.l_words)[:, 0].nbytes)
            + int(np.asarray(self.samples).nbytes)
        )


# ---------------------------------------------------------------------------
# Subset wavelet tree
# ---------------------------------------------------------------------------


def _wt4_root_rank1(wt: WaveletTree, pos):
    """rank of symbols {2,3} (left-presence bit) before pos."""
    return wt.levels[0].rank(pos)


def _wt4_pair_rank(wt: WaveletTree, pos, root_r1):
    """(count of symbol 1, count of symbol 3) before pos, given root rank1."""
    lvl1 = wt.levels[1]
    base_l = wt.node_base[1]
    rank_l = wt.node_rank[1]
    base_r = wt.node_base[2]
    rank_r = wt.node_rank[2]
    c1 = lvl1.rank(base_l + (pos - root_r1)) - rank_l
    c3 = lvl1.rank(base_r + root_r1) - rank_r
    return c1, c3


def _wt4_pair_rank_pair(wt: WaveletTree, p, padv, r, radv):
    """Paired form of _wt4_pair_rank for positions p and p+padv
    (padv ∈ {0,1}), given the root rank pair (r at p, r+radv at p+padv):
    returns (c1, c3, c1 at p+padv, c3 at p+padv).  Both child arguments
    advance by at most 1, so each costs one bv rank_pair."""
    lvl1 = wt.levels[1]
    base_l = wt.node_base[1]
    rank_l = wt.node_rank[1]
    base_r = wt.node_base[2]
    rank_r = wt.node_rank[2]
    a = p - r
    aadv = padv - radv  # ∈ {0, 1}: the left child's argument advance
    ca, cb = lvl1.rank_pair(base_l + a)
    da, db = lvl1.rank_pair(base_r + r)
    c1 = ca - rank_l
    c1q = jnp.where(aadv == 1, cb, ca) - rank_l
    c3 = da - rank_r
    c3q = jnp.where(radv == 1, db, da) - rank_r
    return c1, c3, c1q, c3q


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["acgt", "ac", "gt"],
    meta_fields=["n", "kind"],
)
@dataclass(frozen=True)
class SubsetWTRank:
    acgt: WaveletTree  # symbols 2*(AC presence) + (GT presence)
    ac: WaveletTree  # symbols 2*A + C over AC-present columns
    gt: WaveletTree  # symbols 2*G + T over GT-present columns
    n: int
    kind: str

    @classmethod
    def from_bits(cls, bits: np.ndarray, kind: str) -> "SubsetWTRank":
        A, Cb, G, T = (bits[i] for i in range(4))
        acp = A | Cb
        gtp = G | T
        acgt_syms = 2 * acp.astype(np.int64) + gtp.astype(np.int64)
        ac_syms = 2 * A[acp].astype(np.int64) + Cb[acp].astype(np.int64)
        gt_syms = 2 * G[gtp].astype(np.int64) + T[gtp].astype(np.int64)
        return cls(
            acgt=WaveletTree.build(acgt_syms, 4, kind),
            ac=WaveletTree.build(ac_syms, 4, kind),
            gt=WaveletTree.build(gt_syms, 4, kind),
            n=bits.shape[1],
            kind=kind,
        )

    def rank(self, c, pos):
        """SubsetWT::rank (SubsetWT.hh:94-113), batched over mixed chars."""
        c = jnp.asarray(c, dtype=jnp.int32)
        pos = jnp.asarray(pos, dtype=jnp.int32)
        c, pos = jnp.broadcast_arrays(c, pos)
        is_ac = c < 2
        root_r1 = _wt4_root_rank1(self.acgt, pos)
        # x for A/C lanes = rank{2,3}; for G/T lanes = rank{1,3}
        c1, c3 = _wt4_pair_rank(self.acgt, pos, root_r1)
        x = jnp.where(is_ac, root_r1, c1 + c3)
        # second level
        ac_root = _wt4_root_rank1(self.ac, jnp.where(is_ac, x, 0))
        gt_root = _wt4_root_rank1(self.gt, jnp.where(is_ac, 0, x))
        a_res = ac_root  # rank{2,3} in AC tree = count of A
        g_res = gt_root
        ac1, ac3 = _wt4_pair_rank(self.ac, jnp.where(is_ac, x, 0), ac_root)
        gt1, gt3 = _wt4_pair_rank(self.gt, jnp.where(is_ac, 0, x), gt_root)
        c_res = ac1 + ac3
        t_res = gt1 + gt3
        return jnp.where(
            c == 0, a_res, jnp.where(c == 1, c_res, jnp.where(c == 2, g_res, t_res))
        )

    def rank_pair(self, c, pos):
        """(rank(c,pos), rank(c,pos+1)) at the gather cost of one rank:
        every tree argument for pos+1 is the pos argument or its +1
        neighbor, so each level answers both from one bv rank_pair."""
        c = jnp.asarray(c, dtype=jnp.int32)
        pos = jnp.asarray(pos, dtype=jnp.int32)
        c, pos = jnp.broadcast_arrays(c, pos)
        is_ac = c < 2
        one = jnp.ones_like(pos)
        zero = jnp.zeros_like(pos)
        r0a, r0b = self.acgt.levels[0].rank_pair(pos)
        c1, c3, c1q, c3q = _wt4_pair_rank_pair(self.acgt, pos, one, r0a, r0b - r0a)
        x = jnp.where(is_ac, r0a, c1 + c3)
        xq = jnp.where(is_ac, r0b, c1q + c3q)
        xadv = xq - x
        acx = jnp.where(is_ac, x, 0)
        acadv = jnp.where(is_ac, xadv, zero)
        gtx = jnp.where(is_ac, 0, x)
        gtadv = jnp.where(is_ac, zero, xadv)
        ac0a, ac0b = self.ac.levels[0].rank_pair(acx)
        ac_rq = jnp.where(acadv == 1, ac0b, ac0a)
        gt0a, gt0b = self.gt.levels[0].rank_pair(gtx)
        gt_rq = jnp.where(gtadv == 1, gt0b, gt0a)
        ac1, ac3, ac1q, ac3q = _wt4_pair_rank_pair(
            self.ac, acx, acadv, ac0a, ac_rq - ac0a
        )
        gt1, gt3, gt1q, gt3q = _wt4_pair_rank_pair(
            self.gt, gtx, gtadv, gt0a, gt_rq - gt0a
        )
        r1 = jnp.where(
            c == 0, ac0a,
            jnp.where(c == 1, ac1 + ac3, jnp.where(c == 2, gt0a, gt1 + gt3)),
        )
        r2 = jnp.where(
            c == 0, ac_rq,
            jnp.where(c == 1, ac1q + ac3q, jnp.where(c == 2, gt_rq, gt1q + gt3q)),
        )
        return r1, r2

    def contains(self, c, pos):
        return self.rank(c, pos + 1) - self.rank(c, pos)

    def to_bits(self) -> np.ndarray:
        acgt = self.acgt.to_symbols()
        acp = acgt >= 2
        gtp = (acgt & 1) == 1
        ac = self.ac.to_symbols()
        gt = self.gt.to_symbols()
        bits = np.zeros((4, self.n), dtype=bool)
        bits[0, acp] = ac >= 2
        bits[1, acp] = (ac & 1) == 1
        bits[2, gtp] = gt >= 2
        bits[3, gtp] = (gt & 1) == 1
        return bits

    def payload(self) -> dict:
        out = {"n": np.int64(self.n)}
        for name, wt in [("acgt", self.acgt), ("ac", self.ac), ("gt", self.gt)]:
            for k, v in wt.payload().items():
                out[f"{name}_{k}"] = v
        return out

    @classmethod
    def from_payload(cls, p: dict, kind: str) -> "SubsetWTRank":
        def sub(prefix):
            return WaveletTree.from_payload(
                {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)},
                kind,
            )

        return cls(
            acgt=sub("acgt_"), ac=sub("ac_"), gt=sub("gt_"), n=int(p["n"]), kind=kind
        )

    def size_in_bytes(self) -> int:
        return (
            self.acgt.size_in_bytes() + self.ac.size_in_bytes() + self.gt.size_in_bytes()
        )


# ---------------------------------------------------------------------------
# Variant registry (variants.hh:19-63)
# ---------------------------------------------------------------------------

# variant name -> (structure class, ctor kwargs)
VARIANT_STRUCTS = {
    "rrr-matrix": (MatrixRank, {"kind": "rrr"}),
    "mef-matrix": (MatrixRank, {"kind": "mef"}),
    "plain-split": (SplitRank, {"x_kind": "plain", "z_kind": "plain"}),
    "rrr-split": (SplitRank, {"x_kind": "rrr", "z_kind": "plain"}),
    "mef-split": (SplitRank, {"x_kind": "mef", "z_kind": "plain"}),
    "plain-concat": (ConcatRank, {"wt_kind": "plain"}),
    "mef-concat": (ConcatRank, {"wt_kind": "rrr"}),  # reference: wt over rrr bvs
    "plain-subsetwt": (SubsetWTRank, {"kind": "plain"}),
    "rrr-subsetwt": (SubsetWTRank, {"kind": "rrr"}),
}


def build_struct(variant: str, bits: np.ndarray):
    cls, kw = VARIANT_STRUCTS[variant]
    return cls.from_bits(bits, **kw)


def struct_from_payload(variant: str, payload: dict):
    cls, kw = VARIANT_STRUCTS[variant]
    return cls.from_payload(payload, **kw)
