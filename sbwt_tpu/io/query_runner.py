"""Read batching + query execution + exact-format output writing.

The host pipeline around the device engines, replacing the reference's
single-threaded per-read loop (src/CLI/sbwt_search.cpp:46-105) with
padded lockstep batches.  Output bytes are exactly print_vector's format
(sbwt_search.cpp:21-43): each rank followed by a space, newline per read.
"""
from __future__ import annotations

import gzip
import time

import numpy as np

from ..utils.dna import encode_query
from ..utils.logging import write_log

# Shape bucketing limits recompilation: batch dims are padded up to these.
# The ceiling matters: dependent-gather throughput is latency-bound and
# climbs with the number of lanes in flight, so big query files are
# dispatched in up-to-1M-read device batches (~128 MB of codes at 100 bp,
# small next to device memory).
_LEN_QUANTUM = 32
_BATCH_SIZES = [256, 1024, 4096, 16384, 65536, 262144, 1048576]


def _pad_batch_size(n: int) -> int:
    for b in _BATCH_SIZES:
        if n <= b:
            return b
    return -(-n // _BATCH_SIZES[-1]) * _BATCH_SIZES[-1]


def encode_reads(reads: list[bytes], pad_len: int | None = None):
    """Encode raw byte reads into a padded [B, L] int8 batch (+lengths)."""
    B = _pad_batch_size(len(reads))
    maxlen = max((len(r) for r in reads), default=0)
    L = pad_len or max(-(-maxlen // _LEN_QUANTUM) * _LEN_QUANTUM, _LEN_QUANTUM)
    codes = np.full((B, L), -1, dtype=np.int8)
    lengths = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = encode_query(r)
        lengths[i] = len(r)
    return codes, lengths


def format_answers(ans_rows: list[np.ndarray]) -> bytes:
    """print_vector-compatible formatting: 'r1 r2 ... rn \\n' per read."""
    from .. import native

    if native.available() and ans_rows:
        lens = np.array([len(r) for r in ans_rows], dtype=np.int64)
        vals = (
            np.concatenate([np.asarray(r, dtype=np.int64) for r in ans_rows])
            if lens.sum()
            else np.empty(0, dtype=np.int64)
        )
        return native.format_ranks(vals, lens)
    out = bytearray()
    for row in ans_rows:
        if len(row):
            out += " ".join(map(str, row.tolist())).encode()
            out += b" \n"
        else:
            out += b"\n"
    return bytes(out)


def run_queries_on_reads(sbwt, reads: list[bytes]):
    """Query all k-mers of the reads; returns (rows, n_queries, engine_seconds)."""
    k = sbwt.k
    rows: list[np.ndarray] = []
    n_queries = 0
    engine_s = 0.0
    streaming = sbwt.has_streaming_query_support()

    # Group reads into length buckets to keep padding waste low while
    # reusing compiled shapes.
    order = np.argsort([len(r) for r in reads], kind="stable")
    grouped: dict[int, list[int]] = {}
    for i in order:
        L = max(-(-max(len(reads[i]), 1) // _LEN_QUANTUM) * _LEN_QUANTUM, _LEN_QUANTUM)
        grouped.setdefault(L, []).append(int(i))

    results: dict[int, np.ndarray] = {}
    for L, idxs in grouped.items():
        for s in range(0, len(idxs), _BATCH_SIZES[-1]):
            chunk = idxs[s : s + _BATCH_SIZES[-1]]
            batch = [reads[i] for i in chunk]
            codes, lengths = encode_reads(batch, pad_len=L)
            t0 = time.perf_counter()
            if L < k:
                ans = np.empty((len(codes), 0), dtype=np.int32)
            elif streaming:
                ans = sbwt.streaming_search_batch(codes, lengths)
            else:
                ans = _per_kmer_batch(sbwt, codes, lengths)
            engine_s += time.perf_counter() - t0
            for j, i in enumerate(chunk):
                n_out = max(0, len(reads[i]) - k + 1)
                results[i] = np.asarray(ans[j, :n_out])
                n_queries += n_out

    rows = [results[i] for i in range(len(reads))]
    return rows, n_queries, engine_s


def _per_kmer_batch(sbwt, codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Non-streaming fallback: full search at every position
    (sbwt_search.cpp:68-91 semantics)."""
    B, L = codes.shape
    k = sbwt.k
    P = L - k + 1
    # windows as a strided view -> [B*P, k] full searches
    wins = np.lib.stride_tricks.sliding_window_view(codes, k, axis=1)  # [B, P, k]
    flat = wins.reshape(B * P, k)
    ans = sbwt.search_batch(flat).reshape(B, P)
    pos_ok = np.arange(P)[None, :] <= (lengths[:, None] - k)
    return np.where(pos_ok, ans, -1)


def _padded_from_flat(codes_flat: np.ndarray, offs: np.ndarray, pad_len: int):
    """[B, L] padded batch + lengths from a flat encoded stream (vectorized)."""
    lengths = np.diff(offs).astype(np.int32)
    B = len(lengths)
    out = np.full((B, pad_len), -1, dtype=np.int8)
    mask = np.arange(pad_len)[None, :] < lengths[:, None]
    out[mask] = codes_flat[: offs[-1]]
    return out, lengths


def _run_file_native(sbwt, src: str, out_f) -> tuple[int, float]:
    """Streaming pipeline: native reader -> device batches -> native
    formatter, never materializing per-read Python objects."""
    from .. import native

    k = sbwt.k
    streaming = sbwt.has_streaming_query_support()
    n_queries = 0
    engine_s = 0.0
    with native.NativeSequenceReader(src) as reader:
        for codes_flat, offs in reader:
            lens = np.diff(offs)
            maxlen = int(lens.max()) if len(lens) else 0
            L = max(-(-max(maxlen, 1) // _LEN_QUANTUM) * _LEN_QUANTUM, _LEN_QUANTUM)
            codes, lengths = _padded_from_flat(codes_flat, offs, L)
            t0 = time.perf_counter()
            if L < k:
                ans = np.empty((len(codes), 0), dtype=np.int32)
            elif streaming:
                ans = sbwt.streaming_search_batch(codes, lengths)
            else:
                ans = _per_kmer_batch(sbwt, codes, lengths)
            engine_s += time.perf_counter() - t0
            out_lens = np.maximum(lengths.astype(np.int64) - k + 1, 0)
            n_queries += int(out_lens.sum())
            P = ans.shape[1]
            mask = np.arange(P)[None, :] < out_lens[:, None]
            vals = ans[mask].astype(np.int64)
            out_f.write(native.format_ranks(vals, out_lens))
    return n_queries, engine_s


def run_query_files(sbwt, in_files: list[str], out_files: list[str], gzip_output: bool):
    """Full `sbwt search` equivalent over file lists (sbwt_search.cpp:109-141)."""
    from .. import native
    from .seqio import iter_sequence_batches

    total_queries = 0
    for src, dst in zip(in_files, out_files):
        write_log(
            f"Running {'streaming' if sbwt.has_streaming_query_support() else 'non-streaming'}"
            f" queries from input file {src} to output file {dst}"
        )
        out_f = gzip.open(dst, "wb") if gzip_output else open(dst, "wb")
        try:
            if native.available():
                n_queries, engine_s = _run_file_native(sbwt, src, out_f)
            else:
                # pure-Python fallback: bounded read batches, answers
                # written per batch — never the whole file in memory
                n_queries = 0
                engine_s = 0.0
                for reads in iter_sequence_batches(src):
                    rows, nq, es = run_queries_on_reads(sbwt, reads)
                    out_f.write(format_answers(rows))
                    n_queries += nq
                    engine_s += es
        finally:
            out_f.close()
        total_queries += n_queries
        if n_queries:
            write_log(
                f"us/query: {engine_s * 1e6 / n_queries} (excluding I/O etc)"
            )
    return total_queries
