"""High-level SBWT API: the user-facing index object.

Mirrors the public surface of the reference `SBWT<subset_rank_t>` class
(include/sbwt/SBWT.hh:31-332) — search, streaming_search, partial_search,
forward, serialize/load, reconstruct_all_kmers, get_kmer, ascii export —
while the heavy lifting runs as batched jit-compiled engines over the
device-resident index (ops/search.py).

Host-side features that the reference implements with per-column scalar
loops (reconstruction, k-mer extraction, ascii export) are vectorized
numpy here; they are tooling paths, not the query hot path.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..construct.inmemory import BuiltSBWT, build_sbwt
from ..ops import search as engines
from ..utils.dna import CODE_TO_CHAR, encode_query
from .matrix import MatrixIndex, build_device_index, from_host_arrays, with_precalc

VARIANT_NAMES = [
    "plain-matrix",
    "rrr-matrix",
    "mef-matrix",
    "plain-split",
    "rrr-split",
    "mef-split",
    "plain-concat",
    "mef-concat",
    "plain-subsetwt",
    "rrr-subsetwt",
]


_jit_search = jax.jit(engines.search_batch)
_jit_streaming = jax.jit(engines.streaming_search)
_jit_partial = jax.jit(engines.partial_search_batch)
_jit_update_interval = jax.jit(engines.update_interval_batch)
_jit_forward = jax.jit(engines.forward_batch)


class SBWT:
    """SBWT index with batched device query engines.

    `variant` selects the subset-rank structure (variants.hh:19-63):
    plain-matrix uses the fused-row MatrixIndex; the other nine use the
    corresponding compressed structure behind the same engine interface.
    All variants answer identical queries.
    """

    def __init__(
        self,
        bits: np.ndarray,
        suffix_group_starts: np.ndarray | None,
        k: int,
        n_kmers: int,
        precalc_k: int = 0,
        variant: str = "plain-matrix",
        precalc_table: np.ndarray | None = None,
    ):
        self._set_host_bits(bits, suffix_group_starts)
        self.variant = variant
        if variant == "plain-matrix":
            self.device_index = from_host_arrays(
                self.bits,
                self.suffix_group_starts,
                k=k,
                n_kmers=n_kmers,
                precalc_k=precalc_k,
                precalc_table=precalc_table,
            )
        else:
            from .variants import build_generic_index

            self.device_index = build_generic_index(
                variant,
                self.bits,
                self.suffix_group_starts,
                k=k,
                n_kmers=n_kmers,
                precalc_k=precalc_k,
                precalc_table=precalc_table,
            )

    def _set_host_bits(self, bits, suffix_group_starts):
        """Host copies are retained PACKED (1 bit/entry, not numpy's
        1 byte/bool): at pangenome scale the 8x difference is GBs of host
        RAM.  `.bits` / `.suffix_group_starts` unpack on demand."""
        bits = np.asarray(bits, dtype=bool)
        self._n_cols = bits.shape[1]
        self._bits_packed = np.packbits(bits, axis=1, bitorder="little")
        sgs = (
            np.asarray(suffix_group_starts, dtype=bool)
            if suffix_group_starts is not None
            else np.empty(0, dtype=bool)
        )
        self._n_sgs = len(sgs)
        self._sgs_packed = np.packbits(sgs, bitorder="little")

    @property
    def bits(self) -> np.ndarray:
        """The four indicator rows as bools [4, n] (unpacked on demand)."""
        return np.unpackbits(
            self._bits_packed, axis=1, bitorder="little", count=self._n_cols
        ).astype(bool)

    @property
    def suffix_group_starts(self) -> np.ndarray:
        return np.unpackbits(
            self._sgs_packed, bitorder="little", count=self._n_sgs
        ).astype(bool)

    @classmethod
    def from_device_index(cls, device_index, bits, suffix_group_starts):
        """Wrap an already-built device index (e.g. loaded from a payload)."""
        self = object.__new__(cls)
        self._set_host_bits(bits, suffix_group_starts)
        self.variant = getattr(device_index, "variant", "plain-matrix")
        self.device_index = device_index
        return self

    @classmethod
    def from_packed(
        cls,
        bits_packed: np.ndarray,
        n: int,
        sgs_packed: np.ndarray | None,
        k: int,
        n_kmers: int,
        precalc_k: int = 0,
        precalc_table: np.ndarray | None = None,
    ):
        """Build a plain-matrix SBWT from byte-packed rows [4, ceil(n/8)]
        without ever materializing bool arrays (the native-format load
        path; 8 bytes/column saved — required at pangenome scale).  Routes
        to the int64 engine automatically at n >= 2^31."""
        from .matrix import from_packed_rows

        self = object.__new__(cls)
        self.variant = "plain-matrix"
        self._n_cols = int(n)
        self._bits_packed = np.ascontiguousarray(bits_packed, dtype=np.uint8)
        if sgs_packed is not None:
            self._n_sgs = int(n)
            self._sgs_packed = np.ascontiguousarray(sgs_packed, dtype=np.uint8)
        else:
            self._n_sgs = 0
            self._sgs_packed = np.zeros(0, dtype=np.uint8)

        def to_words(packed_rows):
            W = n // 32 + 1
            buf = np.zeros((packed_rows.shape[0], W * 4), dtype=np.uint8)
            buf[:, : packed_rows.shape[1]] = packed_rows
            return buf.view("<u4").astype(np.uint32)

        row_words = to_words(self._bits_packed)
        sgs_words = (
            to_words(self._sgs_packed[None, :])[0] if sgs_packed is not None else None
        )
        self.device_index = from_packed_rows(
            row_words, n, sgs_words, k=k, n_kmers=n_kmers,
            precalc_k=precalc_k, precalc_table=precalc_table,
        )
        return self

    def to_variant(self, variant: str) -> "SBWT":
        """Re-encode into another variant, preserving k / n_kmers / precalc
        (the build-variant path, src/CLI/sbwt_build_from_plain_matrix.cpp)."""
        return SBWT(
            self.bits,
            self.suffix_group_starts if self.has_streaming_query_support() else None,
            k=self.k,
            n_kmers=self.number_of_kmers(),
            precalc_k=self.get_precalc_k(),
            variant=variant,
            precalc_table=(
                np.asarray(self.device_index.precalc)
                if self.get_precalc_k() > 0
                else None
            ),
        )

    def structure_size_in_bytes(self) -> int:
        """Size of the subset-rank structure (for bits/k-mer logging)."""
        di = self.device_index
        if hasattr(di, "struct"):
            return di.struct.size_in_bytes()
        return int(np.asarray(di.rank_tbl).nbytes)

    # ---- constructors -------------------------------------------------
    @classmethod
    def from_built(cls, built: BuiltSBWT, precalc_k: int = 0, variant: str = "plain-matrix"):
        return cls(
            built.bits,
            built.suffix_group_starts,
            built.k,
            built.n_kmers,
            precalc_k,
            variant,
        )

    @classmethod
    def build_on_device(
        cls,
        seqs,
        k: int,
        streaming_support: bool = True,
        precalc_k: int = 0,
        src_pad: int | None = None,
    ):
        """Construct ON the device: the whole pipeline (window packing,
        colex sort, dedup, out-edge joins, dummy emission, rank-table
        packing) runs as one compiled XLA program (construct/device.py) —
        the device-native replacement for the reference's KMC + EM-sort
        path.
        k <= 32; raises ValueError on pathologically fragmented inputs
        (source budget), where the host builder is the fallback.

        The host packed copies (serialization, variant re-encode) are
        recovered from the device rank tables in one small download
        (n/2 bytes)."""
        from ..construct.device import build_sbwt_device

        di = build_sbwt_device(
            seqs, k, streaming_support=streaming_support,
            precalc_k=precalc_k, src_pad=src_pad,
        )
        self = object.__new__(cls)
        self.variant = "plain-matrix"
        self.device_index = di
        n = di.n_nodes
        self._n_cols = n
        nb = (n + 7) // 8
        words = np.asarray(di.rank_tbl[:, 0]).astype(np.uint32)
        rows = words.reshape(4, di.n_words).view(np.uint8)
        self._bits_packed = np.ascontiguousarray(rows[:, :nb])
        if di.has_streaming:
            sgs_words = np.asarray(di.sgs_tbl[:, 0]).astype(np.uint32)
            self._sgs_packed = np.ascontiguousarray(sgs_words.view(np.uint8)[:nb])
            self._n_sgs = n
        else:
            self._sgs_packed = np.zeros(0, dtype=np.uint8)
            self._n_sgs = 0
        return self

    @classmethod
    def build(
        cls,
        seqs,
        k: int,
        streaming_support: bool = True,
        precalc_k: int = 0,
        min_abundance: int = 1,
        max_abundance: int | None = None,
        add_reverse_complements: bool = False,
        variant: str = "plain-matrix",
        method: str = "auto",
        ram_bytes: int = 2 << 30,
        n_threads: int = 4,
        temp_dir: str | None = None,
        input_bases: int | None = None,
    ):
        """Construct from sequences.  method: 'memory' (vectorized in-RAM),
        'external' (native EM-sort pipeline, construct/external.py), or
        'auto' (external when the k-mer record spill would exceed half the
        RAM budget — the reference always goes through KMC+disk).

        `seqs` may be a LIST of sequences/code arrays or a bounded-memory
        GENERATOR (the CLI streams FASTA files through one, like the
        reference's kmc_construct.hh:206-238 which never holds the corpus).
        Generators require `input_bases` (estimated total bases, e.g. from
        file sizes) for the auto heuristic, and route to the external
        builder, which consumes them one chunk at a time."""
        streamed = not hasattr(seqs, "__len__")
        if method == "auto":
            from ..utils import kmers_wide as _kw

            rec_bytes = 8 * _kw.n_words(k)  # wide k-mers spill W-word records
            bases = (
                input_bases
                if input_bases is not None
                else sum(len(s) for s in seqs)
            )
            if streamed and input_bases is None:
                raise ValueError(
                    "auto method needs input_bases when seqs is a generator"
                )
            est = bases * rec_bytes * (2 if add_reverse_complements else 1)
            method = "external" if est > ram_bytes // 2 else "memory"
        if streamed and method == "memory":
            seqs = list(seqs)  # the in-RAM builder needs the whole corpus
        if method == "external":
            from ..construct.external import build_sbwt_external

            built = build_sbwt_external(
                seqs,
                k,
                streaming_support=streaming_support,
                min_abundance=min_abundance,
                max_abundance=max_abundance,
                add_reverse_complements=add_reverse_complements,
                ram_bytes=ram_bytes,
                n_threads=n_threads,
                temp_dir=temp_dir,
            )
        else:
            built = build_sbwt(
                seqs,
                k,
                streaming_support=streaming_support,
                min_abundance=min_abundance,
                max_abundance=max_abundance,
                add_reverse_complements=add_reverse_complements,
            )
        if hasattr(built, "bits_packed"):
            # streaming build emits packed rows; never unpack to bool
            self = cls.from_packed(
                built.bits_packed,
                built.n_cols,
                built.sgs_packed,
                k=built.k,
                n_kmers=built.n_kmers,
                precalc_k=precalc_k,
            )
            return self.to_variant(variant) if variant != "plain-matrix" else self
        return cls.from_built(built, precalc_k, variant)

    # ---- metadata (SBWT.hh accessors) --------------------------------
    @property
    def k(self) -> int:
        return self.device_index.k

    def number_of_subsets(self) -> int:
        return self.device_index.n_nodes

    def number_of_kmers(self) -> int:
        return self.device_index.n_kmers

    def get_precalc_k(self) -> int:
        return self.device_index.precalc_k

    @property
    def C(self) -> np.ndarray:
        return np.asarray(self.device_index.C, dtype=np.int64)

    def has_streaming_query_support(self) -> bool:
        return self.device_index.has_streaming

    # Reference-named aliases (SBWT.hh:111-157), so code written against
    # the C++ API maps one-to-one.
    def get_k(self) -> int:
        return self.k

    def get_C_array(self) -> np.ndarray:
        return self.C

    def get_precalc(self) -> np.ndarray:
        """Precalc intervals as an [4^p, 2] array of (left, right); empty
        intervals are (-1, -1) (SBWT.hh:131)."""
        if self.get_precalc_k() == 0:
            return np.empty((0, 2), dtype=np.int64)
        return np.asarray(self.device_index.precalc, dtype=np.int64)

    def get_streaming_support(self) -> np.ndarray:
        """The suffix_group_starts bit vector as bools (SBWT.hh:116)."""
        return np.asarray(self.suffix_group_starts, dtype=bool)

    def get_subset_rank_structure(self):
        """The underlying device index / subset-rank structure
        (SBWT.hh:111)."""
        return self.device_index

    def do_kmer_prefix_precalc(self, p: int) -> None:
        if self.variant == "plain-matrix":
            self.device_index = with_precalc(self.device_index, p)
        else:
            from .variants import generic_with_precalc

            self.device_index = generic_with_precalc(self.device_index, p)

    # ---- queries ------------------------------------------------------
    def search_batch(self, codes: np.ndarray) -> np.ndarray:
        """Batched k-mer search; codes int [B, k] from encode_query."""
        return np.asarray(_jit_search(self.device_index, jnp.asarray(codes)))

    def search(self, kmer: str) -> int:
        """Single k-mer search (SBWT.hh:390-415). Longer inputs use the first k chars."""
        codes = encode_query(kmer[: self.k])
        if len(codes) != self.k:
            raise ValueError(f"query shorter than k={self.k}")
        return int(self.search_batch(codes[None, :])[0])

    def enable_turbo(
        self, arity: int | None = None, free_bytes: int | None = None
    ) -> int | None:
        """Build the successor turbo table (ops/turbo.py): 16 B (arity 1),
        128 B (arity 2) or 1 KiB (arity 3) of device memory per column,
        for fewer dependent gathers per streaming answer.  Exact same
        answers; used automatically by streaming_search_batch.

        arity=None measures free device memory and picks the largest
        affordable tier, degrading 3 -> 2 -> 1 (16 B/column row tier) ->
        LF (returns None and leaves the LF engine active) instead of
        OOMing.  Returns the arity enabled.  free_bytes overrides the
        measurement (tests)."""
        from ..ops.turbo import build_turbo
        from ..utils.memory import select_turbo_arity

        if self.device_index.precalc_k <= 0:
            # the turbo engine's singleton-seed fast path needs a precalc
            # table (a walk from the 0-char state is an interval, not a
            # column); indexes built without one get the reference's
            # default prefix length here (sbwt_build.cpp -p 8)
            self.do_kmer_prefix_precalc(min(self.k, 8))
        if arity is None:
            wide = getattr(self.device_index, "pos_dtype", jnp.int32) == jnp.int64
            arity = select_turbo_arity(
                self.number_of_subsets(), free_bytes, self.device_index.precalc_k,
                wide=wide,
            )
            if arity is None:
                self._turbo = None
                return None
        self._turbo = build_turbo(self.device_index, arity=arity)
        self._turbo_engine = None  # reset adaptation state for the new table
        return arity

    def streaming_search_batch(
        self, codes: np.ndarray, lengths: np.ndarray | None = None
    ) -> np.ndarray:
        """Batched streaming search; codes int [B, L] padded with -1."""
        if not self.has_streaming_query_support():
            raise RuntimeError("streaming search support not built")
        B, L = codes.shape
        if lengths is None:
            lengths = np.full(B, L, dtype=np.int32)
        turbo = getattr(self, "_turbo", None)
        if turbo is not None:
            from ..ops.turbo import AdaptiveTurboEngine

            # adaptive hinting: each batch's measured hit fraction picks
            # the static regime hint for the next batch, so the
            # production path runs the hinted (cond-free) programs
            # without a workload declaration (ops/turbo.py)
            eng = getattr(self, "_turbo_engine", None)
            if eng is None or eng.turbo is not turbo or eng.index is not self.device_index:
                eng = AdaptiveTurboEngine(turbo, self.device_index)
                self._turbo_engine = eng
            return np.asarray(
                eng.search(
                    jnp.asarray(codes), jnp.asarray(lengths, dtype=jnp.int32)
                )
            )
        return np.asarray(
            _jit_streaming(
                self.device_index, jnp.asarray(codes), jnp.asarray(lengths, dtype=jnp.int32)
            )
        )

    def streaming_search(self, text: str) -> list[int]:
        """All k-mer answers of one input string (SBWT.hh:545-581)."""
        if len(text) < self.k:
            return []
        codes = encode_query(text)
        ans = self.streaming_search_batch(codes[None, :])
        return [int(x) for x in ans[0]]

    def partial_search(self, text: str) -> tuple[tuple[int, int], int]:
        """Longest matching prefix interval (SBWT.hh:526-537)."""
        codes = encode_query(text)
        l, r, mlen = _jit_partial(
            self.device_index,
            jnp.asarray(codes[None, :]),
            jnp.asarray([len(text)], dtype=jnp.int32),
        )
        return (int(l[0]), int(r[0])), int(mlen[0])

    def update_sbwt_interval(self, s: str, interval: tuple[int, int]) -> tuple[int, int]:
        """Run LF iterations from a given interval (SBWT.hh:423-437)."""
        if interval[0] == -1:
            return interval
        codes = encode_query(s)
        # search semantics: raw char must be uppercase ACGT
        codes = np.where((codes >= 0) & (codes < 4), codes, -1)
        l, r, alive = _jit_update_interval(
            self.device_index,
            jnp.asarray(codes[None, :]),
            jnp.asarray([interval[0]], dtype=jnp.int32),
            jnp.asarray([interval[1]], dtype=jnp.int32),
        )
        if not bool(alive[0]):
            return (-1, -1)
        return (int(l[0]), int(r[0]))

    def forward(self, node: int, c: str) -> int:
        """Follow a labeled edge in the de Bruijn graph (SBWT.hh:369-381)."""
        if not self.has_streaming_query_support():
            raise RuntimeError("streaming support required for forward")
        code = int(encode_query(c)[0])
        if code < 0 or code >= 4:
            return -1
        res = _jit_forward(
            self.device_index,
            jnp.asarray([node], dtype=jnp.int32),
            jnp.asarray([code], dtype=jnp.int32),
        )
        return int(res[0])

    # ---- host-side tooling -------------------------------------------
    def compute_dummy_node_marks(self) -> np.ndarray:
        """Mark nodes that are not full k-mers, by BFS over the dummy tree
        (SBWT.hh:589-614), level-synchronous and batched."""
        marks = np.zeros(self.number_of_subsets(), dtype=bool)
        frontier = np.array([0], dtype=np.int32)
        fwd = _jit_forward
        for depth in range(self.k):
            marks[frontier] = True
            if depth == self.k - 1:
                break
            nxt = []
            for c in range(4):
                res = np.asarray(
                    fwd(
                        self.device_index,
                        jnp.asarray(frontier),
                        jnp.full(len(frontier), c, dtype=jnp.int32),
                    )
                )
                nxt.append(res[res >= 0])
            frontier = np.concatenate(nxt).astype(np.int32)
            if len(frontier) == 0:
                break
        return marks

    def _incoming_labels(self) -> np.ndarray:
        """last[i] = label of the incoming edge of column i (-1 for '$')."""
        n = self.number_of_subsets()
        bits = self.bits  # unpack once
        counts = bits.sum(axis=1, dtype=np.int64)
        C = self.C
        last = np.full(n, -1, dtype=np.int8)
        for c in range(4):
            last[C[c] : C[c] + counts[c]] = c
        return last

    def reconstruct_all_kmers(self) -> str:
        """All node labels in colex order, '$'-padded, concatenated
        (SBWT.hh:648-698), as k rounds of vectorized label propagation."""
        n = self.number_of_subsets()
        k = self.k
        bits = self.bits  # unpack once
        counts = bits.sum(axis=1, dtype=np.int64)
        C = self.C
        out = np.full((n, k), ord("$"), dtype=np.uint8)
        last = self._incoming_labels()
        for rnd in range(k):
            col = np.where(last >= 0, CODE_TO_CHAR[np.clip(last, 0, 3)], ord("$"))
            out[:, k - 1 - rnd] = col
            propagated = np.full(n, -1, dtype=np.int8)
            for c in range(4):
                src = np.flatnonzero(bits[c])
                propagated[C[c] : C[c] + len(src)] = last[src]
            last = propagated
        return out.tobytes().decode("ascii")

    def get_kmer(self, colex_rank: int) -> str:
        """Label of one column, via backward steps (SBWT.hh:701-725)."""
        sel = self.select_support()
        return self.get_kmer_fast(colex_rank, sel)

    def select_support(self):
        from .select import MatrixSelectSupport

        if not hasattr(self, "_select_support"):
            self._select_support = MatrixSelectSupport(self.bits)
        return self._select_support

    def get_kmer_fast(self, colex_rank: int, ss) -> str:
        """Label via select support (SBWT.hh:729-746)."""
        C = self.C
        buf = [""] * self.k
        for i in range(self.k):
            if colex_rank == 0:
                buf[self.k - 1 - i] = "$"
            else:
                char_idx = int(np.searchsorted(C, colex_rank, side="right") - 1)
                buf[self.k - 1 - i] = "ACGT"[char_idx]
                rel = colex_rank - int(C[char_idx]) + 1  # 1-based
                colex_rank = ss.select(rel, char_idx)
        return "".join(buf)

    def get_kmers_batch(self, colex_ranks) -> list[str]:
        """Labels of many columns at once: the vectorized counterpart of
        get_kmer_fast (SBWT.hh:729-746) — k rounds of batched
        searchsorted + select over the whole column set."""
        ss = self.select_support()
        C = self.C
        cur = np.asarray(colex_ranks, dtype=np.int64).copy()
        out = np.full((len(cur), self.k), ord("$"), dtype=np.uint8)
        for i in range(self.k):
            nz = np.flatnonzero(cur > 0)
            if len(nz) == 0:
                break
            ci = np.searchsorted(C, cur[nz], side="right") - 1
            out[nz, self.k - 1 - i] = CODE_TO_CHAR[ci]
            rel = cur[nz] - C[ci] + 1  # 1-based rank within character block
            nxt = np.empty(len(nz), dtype=np.int64)
            for c in range(4):
                m = ci == c
                if m.any():
                    nxt[m] = ss.positions[c][rel[m] - 1]
            nxt_cur = np.zeros_like(cur)
            nxt_cur[nz] = nxt
            cur = nxt_cur
        return [bytes(row).decode("ascii") for row in out]

    def ascii_export_metadata(self) -> str:
        """Metadata block of `sbwt ascii-export` (SBWT.hh:777-784)."""
        from ..io.serialize import SBWT_VERSION

        return (
            f"version: {SBWT_VERSION}\n"
            f"k: {self.k}\n"
            f"number_of_sets: {self.number_of_subsets()}\n"
            f"number_of_kmers: {self.number_of_kmers()}\n"
        )

    def ascii_export_sets(self) -> str:
        """Concatenated sets, last member lowercased, '$' for empty sets
        (SBWT.hh:750-773), vectorized."""
        n = self.number_of_subsets()
        bits = self.bits  # unpack once
        sizes = bits.sum(axis=0)
        pieces = []
        chars = np.empty((4, n), dtype=np.uint8)
        for c in range(4):
            chars[c] = np.where(bits[c], CODE_TO_CHAR[c], 0)
        # For each column emit its present chars in ACGT order, lowercasing
        # the last; empty sets emit '$'.
        cum = np.cumsum(self.bits, axis=0)  # position of each char within its set
        last_row = np.where(sizes > 0, np.argmax(cum == sizes[None, :], axis=0), -1)
        out = []
        for c in range(4):
            row = chars[c].copy()
            lower_mask = (last_row == c) & bits[c]
            row[lower_mask] += 32  # to lowercase
            out.append(row)
        stacked = np.stack(out)  # [4, n]
        # Build the final byte string column-major, skipping zeros, and '$'
        # for empty columns.
        col_major = stacked.T  # [n, 4]
        dollar = (sizes == 0).astype(np.uint8) * np.uint8(ord("$"))
        with_dollar = np.concatenate([col_major, dollar[:, None]], axis=1).ravel()
        return with_dollar[with_dollar != 0].tobytes().decode("ascii") + "\n"
