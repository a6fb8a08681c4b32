"""Balanced wavelet tree over a small alphabet, generic over the bit-vector
class (plain / rrr / mef from ops/bv.py).

Device-native equivalent of sdsl::wt_blcd as used by the reference's split,
concat, and subset-WT structures (SubsetSplitRank.hh:17-21,
SubsetConcatRank.hh:36-41, SubsetWT.hh:87-90): the alphabet {0..sigma-1}
is split recursively in halves.  All nodes of one depth are concatenated
into a single level bit vector, so `rank(sym, pos)` costs exactly one
bit-vector rank per level (ceil(log2 sigma) gathers per query), fully
batched even when lanes query different symbols.

The tree shape differs from sdsl's byte-tree internals; only rank
semantics and size class are reproduced (no cpp-format serialization for
wavelet-tree variants).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .bv import BV_CLASSES


def _build_shape(lo: int, hi: int, depth: int, nodes: list) -> int | None:
    if hi - lo <= 1:
        return None
    mid = (lo + hi + 1) // 2
    nid = len(nodes)
    nodes.append({"lo": lo, "mid": mid, "hi": hi, "depth": depth})
    left = _build_shape(lo, mid, depth + 1, nodes)
    right = _build_shape(mid, hi, depth + 1, nodes)
    nodes[nid]["left"] = left
    nodes[nid]["right"] = right
    return nid


def _symbol_paths(sigma: int, nodes: list, root: int | None, D: int):
    """Per-symbol descent paths [sigma, D]: node id, go-right bit, valid."""
    path_node = np.zeros((sigma, D), dtype=np.int32)
    path_bit = np.zeros((sigma, D), dtype=np.int32)
    path_valid = np.zeros((sigma, D), dtype=bool)
    for s in range(sigma):
        nid = root
        d = 0
        while nid is not None:
            node = nodes[nid]
            right = s >= node["mid"]
            path_node[s, d] = nid
            path_bit[s, d] = int(right)
            path_valid[s, d] = True
            nid = node["right"] if right else node["left"]
            d += 1
    return path_node, path_bit, path_valid


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["levels", "node_base", "node_rank", "path_node", "path_bit", "path_valid"],
    meta_fields=["sigma", "n", "depth", "bv_kind"],
)
@dataclass(frozen=True)
class WaveletTree:
    levels: tuple  # one BV per depth (concatenation of that depth's nodes)
    node_base: jax.Array  # int32 [n_nodes] bit offset of node within its level
    node_rank: jax.Array  # int32 [n_nodes] count of 1s before node start
    path_node: jax.Array  # int32 [sigma, D]
    path_bit: jax.Array  # int32 [sigma, D]
    path_valid: jax.Array  # bool [sigma, D]
    sigma: int
    n: int
    depth: int
    bv_kind: str

    @classmethod
    def build(cls, symbols: np.ndarray, sigma: int, bv_kind: str = "plain"):
        symbols = np.asarray(symbols, dtype=np.int64)
        nodes: list = []
        root = _build_shape(0, sigma, 0, nodes)
        D = max(1, int(np.ceil(np.log2(max(2, sigma)))))
        bv_cls = BV_CLASSES[bv_kind]

        node_bools: dict[int, np.ndarray] = {}
        seqs = {root: symbols} if root is not None else {}
        for nid, node in enumerate(nodes):
            seq = seqs.pop(nid, np.empty(0, dtype=np.int64))
            right = seq >= node["mid"]
            node_bools[nid] = right
            if node["left"] is not None:
                seqs[node["left"]] = seq[~right]
            if node["right"] is not None:
                seqs[node["right"]] = seq[right]

        n_nodes = max(1, len(nodes))
        node_base = np.zeros(n_nodes, dtype=np.int32)
        node_rank = np.zeros(n_nodes, dtype=np.int32)
        levels = []
        for d in range(D):
            ids = [nid for nid, nd in enumerate(nodes) if nd["depth"] == d]
            parts = []
            off = 0
            ones_before = 0
            for nid in ids:
                b = node_bools[nid]
                node_base[nid] = off
                node_rank[nid] = ones_before
                ones_before += int(b.sum())
                parts.append(b)
                off += len(b)
            level_bits = (
                np.concatenate(parts) if parts else np.zeros(0, dtype=bool)
            )
            levels.append(bv_cls.build(level_bits))

        pn, pb, pv = _symbol_paths(sigma, nodes, root, D)
        # remap path_node ids to per-level contiguous? Not needed: node_base
        # and node_rank are indexed by global node id.
        return cls(
            levels=tuple(levels),
            node_base=jnp.asarray(node_base),
            node_rank=jnp.asarray(node_rank),
            path_node=jnp.asarray(pn),
            path_bit=jnp.asarray(pb),
            path_valid=jnp.asarray(pv),
            sigma=sigma,
            n=len(symbols),
            depth=D,
            bv_kind=bv_kind,
        )

    def rank(self, sym, pos):
        """Batched: count of symbol sym in positions [0, pos).  sym and pos
        are broadcast-compatible int32 arrays; lanes may differ in symbol."""
        sym = jnp.asarray(sym, dtype=jnp.int32)
        pos = jnp.asarray(pos, dtype=jnp.int32)
        sym, pos = jnp.broadcast_arrays(sym, pos)
        for d in range(self.depth):
            nid = self.path_node[sym, d]
            bit = self.path_bit[sym, d]
            valid = self.path_valid[sym, d]
            base = self.node_base[nid]
            brank = self.node_rank[nid]
            r1 = self.levels[d].rank(base + pos) - brank
            nxt = jnp.where(bit == 1, r1, pos - r1)
            pos = jnp.where(valid, nxt, pos)
        return pos

    def rank_pair(self, sym, pos):
        """(rank(sym, pos), rank(sym, pos+1)) at the gather cost of ONE
        rank: adjacent positions stay adjacent-or-equal down the tree
        (q - p ∈ {0, 1} at every level), so each level's bit-vector
        rank_pair answers both lanes.  The LF extension step queries
        exactly this pair."""
        sym = jnp.asarray(sym, dtype=jnp.int32)
        pos = jnp.asarray(pos, dtype=jnp.int32)
        sym, pos = jnp.broadcast_arrays(sym, pos)
        p, q = pos, pos + 1
        for d in range(self.depth):
            nid = self.path_node[sym, d]
            bit = self.path_bit[sym, d]
            valid = self.path_valid[sym, d]
            base = self.node_base[nid]
            brank = self.node_rank[nid]
            ra, rb = self.levels[d].rank_pair(base + p)
            rp = ra - brank
            rq = jnp.where(q == p, ra, rb) - brank  # q ∈ {p, p+1}
            np_ = jnp.where(bit == 1, rp, p - rp)
            nq_ = jnp.where(bit == 1, rq, q - rq)
            p = jnp.where(valid, np_, p)
            q = jnp.where(valid, nq_, q)
        return p, q

    # ---- host ----

    def to_symbols(self) -> np.ndarray:
        nodes: list = []
        root = _build_shape(0, self.sigma, 0, nodes)
        if root is None:
            return np.zeros(self.n, dtype=np.int64)
        level_bools = [bv.to_bools() for bv in self.levels]
        node_base = np.asarray(self.node_base)

        def decode(nid, count):
            node = nodes[nid]
            base = node_base[nid]
            bits = level_bools[node["depth"]][base : base + count]
            out = np.empty(count, dtype=np.int64)
            nL, nR = int((~bits).sum()), int(bits.sum())
            left = (
                np.full(nL, node["lo"], dtype=np.int64)
                if node["left"] is None
                else decode(node["left"], nL)
            )
            right = (
                np.full(nR, node["mid"], dtype=np.int64)
                if node["right"] is None
                else decode(node["right"], nR)
            )
            out[~bits] = left
            out[bits] = right
            return out

        return decode(root, self.n)

    def payload(self) -> dict:
        out = {"sigma": np.int64(self.sigma), "n": np.int64(self.n)}
        for i, bv in enumerate(self.levels):
            for k, v in bv.payload().items():
                out[f"lvl{i}_{k}"] = v
        return out

    @classmethod
    def from_payload(cls, p: dict, bv_kind: str) -> "WaveletTree":
        sigma = int(p["sigma"])
        n = int(p["n"])
        bv_cls = BV_CLASSES[bv_kind]
        D = max(1, int(np.ceil(np.log2(max(2, sigma)))))
        levels = []
        for i in range(D):
            prefix = f"lvl{i}_"
            sub = {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}
            levels.append(bv_cls.from_payload(sub))
        # rebuild node_base / node_rank from the decoded level bools
        nodes: list = []
        root = _build_shape(0, sigma, 0, nodes)
        n_nodes = max(1, len(nodes))
        node_base = np.zeros(n_nodes, dtype=np.int32)
        node_rank = np.zeros(n_nodes, dtype=np.int32)
        if nodes:
            level_bools = [bv.to_bools() for bv in levels]
            counts = {root: n}
            for d in range(D):
                ids = [nid for nid, nd in enumerate(nodes) if nd["depth"] == d]
                off = 0
                rank_off = 0
                for nid in ids:
                    cnt = counts.get(nid, 0)
                    node_base[nid] = off
                    node_rank[nid] = rank_off
                    bits = level_bools[d][off : off + cnt]
                    nR = int(bits.sum())
                    nL = cnt - nR
                    if nodes[nid]["left"] is not None:
                        counts[nodes[nid]["left"]] = nL
                    if nodes[nid]["right"] is not None:
                        counts[nodes[nid]["right"]] = nR
                    off += cnt
                    rank_off += nR
        pn, pb, pv = _symbol_paths(sigma, nodes, root, D)
        return cls(
            levels=tuple(levels),
            node_base=jnp.asarray(node_base),
            node_rank=jnp.asarray(node_rank),
            path_node=jnp.asarray(pn),
            path_bit=jnp.asarray(pb),
            path_valid=jnp.asarray(pv),
            sigma=sigma,
            n=n,
            depth=D,
            bv_kind=bv_kind,
        )

    def size_in_bytes(self) -> int:
        return sum(bv.size_in_bytes() for bv in self.levels)
