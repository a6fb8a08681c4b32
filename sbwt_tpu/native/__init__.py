"""Native (C) runtime components: build-on-demand loader + wrappers.

The compute path is JAX/XLA; the host runtime around it is native where
the reference's is (SeqIO reader, EM_sort, output formatting — SURVEY.md
§2.3/§2.4).  The shared library is compiled once with the system g++/cc
and cached next to the sources; every entry point has a pure-Python
fallback so the framework works without a toolchain.

The library is built for the generic target of the host architecture
(no `-march=native`), so a copy that travels with the source tree to
another machine of the same architecture still runs there instead of
stopping on an illegal instruction.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(__file__)
_SO = os.path.join(_DIR, "_libsbwt_native.so")
_SRCS = [os.path.join(_DIR, s) for s in ("seqio.c", "emsort.c", "pack.c")]

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _build() -> bool:
    # compile to a private name and rename into place: processes that
    # build at the same moment never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "cc", "-O3", "-shared", "-fPIC",
        *_SRCS, "-o", tmp, "-lz", "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        src_mtime = max(os.path.getmtime(s) for s in _SRCS)
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < src_mtime:
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _build_failed = True
            return None
        lib.sq_open.restype = ctypes.c_void_p
        lib.sq_open.argtypes = [ctypes.c_char_p]
        lib.sq_close.argtypes = [ctypes.c_void_p]
        lib.sq_read_batch.restype = ctypes.c_int64
        lib.sq_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.sq_format_ranks.restype = ctypes.c_int64
        lib.sq_format_ranks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.em_sort_u64.restype = ctypes.c_int
        lib.em_sort_u64.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int,
        ]
        lib.em_dedup_count_u64.restype = ctypes.c_int64
        lib.em_dedup_count_u64.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.em_sort_u64w.restype = ctypes.c_int
        lib.em_sort_u64w.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.em_dedup_count_u64w.restype = ctypes.c_int64
        lib.em_dedup_count_u64w.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.em_sort_varlen.restype = ctypes.c_int
        lib.em_sort_varlen.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int,
        ]
        lib.pk_spill_windows_u64.restype = ctypes.c_int64
        lib.pk_spill_windows_u64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.pk_pack_windows_u64.restype = ctypes.c_int64
        lib.pk_pack_windows_u64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pk_merge_probe.restype = None
        lib.pk_merge_probe.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# Streaming encoded reader (native SeqIO)
# ---------------------------------------------------------------------------


class NativeSequenceReader:
    """Streams FASTA/FASTQ(.gz) records as encoded int8 query-code batches.

    Yields (codes int8 [total], offsets int64 [n+1]) per batch; the
    encoding matches utils/dna.encode_query.
    """

    def __init__(self, path: str, batch_bases: int = 1 << 27, batch_reads: int = 1 << 20):
        # defaults sized so short-read files reach ~1M reads per device
        # batch (gather throughput climbs to millions of lanes); the
        # 128 MB code buffer bounds long-read batches instead
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.sq_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open sequence file {path!r}")
        self._codes = np.empty(batch_bases, dtype=np.int8)
        self._offsets = np.empty(batch_reads + 1, dtype=np.int64)
        self._batch_reads = batch_reads

    def __iter__(self):
        while True:
            n = self._lib.sq_read_batch(
                self._h,
                self._codes.ctypes.data,
                len(self._codes),
                self._offsets.ctypes.data,
                self._batch_reads,
            )
            if n < 0:
                raise IOError("sequence read failed (record larger than buffer?)")
            if n == 0:
                return
            offs = self._offsets[: n + 1].copy()
            yield self._codes[: offs[-1]].copy(), offs

    def close(self):
        if self._h:
            self._lib.sq_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def format_ranks(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Rank lines byte-identical to the reference's print_vector
    (sbwt_search.cpp:21-43): space-separated with trailing space + newline."""
    lib = get_lib()
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    if lib is None:
        out = []
        for i, ln in enumerate(lens):
            start = int(lens[:i].sum())
            parts = [str(int(v)) for v in vals[start : start + int(ln)]]
            out.append(("".join(p + " " for p in parts)) + "\n")
        return "".join(out).encode()
    cap = max(1024, int(vals.size) * 12 + int(lens.size) * 2)
    buf = ctypes.create_string_buffer(cap)
    w = lib.sq_format_ranks(
        vals.ctypes.data, lens.ctypes.data, len(lens), buf, cap
    )
    if w < 0:
        raise RuntimeError("format_ranks: buffer too small")
    return buf.raw[:w]


# ---------------------------------------------------------------------------
# External-memory sort (EM_sort equivalent)
# ---------------------------------------------------------------------------


def _tofile_checked(arr: np.ndarray, path: str) -> None:
    """ndarray.tofile with the native error contract: a short write (disk
    full mid-stream) raises RuntimeError like the C writers do — a
    truncated 'sorted' stream with rc 0 would build a wrong index."""
    try:
        arr.tofile(path)
    except OSError as e:
        raise RuntimeError(f"short write to {path}: {e}") from e


def em_sort_u64_file(in_path: str, out_path: str, tmp_dir: str,
                     ram_bytes: int = 1 << 30, n_threads: int = 4) -> None:
    lib = get_lib()
    # In-RAM shortcut: when the whole file fits comfortably in the RAM
    # budget, numpy's in-memory sort beats the external-memory block
    # sort + merge ~7x (measured: 16M u64 in 0.20s vs 1.44s) — the EM
    # machinery only pays for itself when the data cannot fit.  The
    # reference's EM_sort takes the same in-memory shortcut for small
    # inputs via its block path (EM_sort.cpp:102-134).
    if lib is None or os.path.getsize(in_path) <= ram_bytes // 2:
        arr = np.fromfile(in_path, dtype=np.uint64)
        arr.sort()
        _tofile_checked(arr, out_path)
        return
    rc = lib.em_sort_u64(
        in_path.encode(), out_path.encode(), tmp_dir.encode(),
        int(ram_bytes), int(n_threads),
    )
    if rc != 0:
        raise RuntimeError(f"em_sort_u64 failed with code {rc}")


def em_dedup_count_u64_file(in_path: str, out_path: str,
                            min_abund: int = 1, max_abund: int = 2**62,
                            ram_bytes: int | None = None) -> int:
    """Adjacent dedup + abundance cutoffs over a SORTED u64 file (the
    sort above always runs first), matching the C streamer's semantics.

    The vectorized in-RAM path peaks at ~3x the file size, so it only
    runs inside the caller's RAM budget (or a 256 MB default when no
    budget is given); the C streamer serves the bounded-memory case."""
    lib = get_lib()
    size = os.path.getsize(in_path)
    threshold = (ram_bytes // 3) if ram_bytes is not None else (256 << 20)
    if lib is None or size <= threshold:
        # in-RAM vectorized path: run-boundary scan of the sorted array
        # (np.unique would re-sort; the C streamer is adjacent-only too)
        arr = np.fromfile(in_path, dtype=np.uint64)
        if len(arr) == 0:
            open(out_path, "wb").close()
            return 0
        change = np.empty(len(arr), dtype=bool)
        change[0] = True
        np.not_equal(arr[1:], arr[:-1], out=change[1:])
        idx = np.flatnonzero(change)
        counts = np.diff(np.append(idx, len(arr)))
        keep = (counts >= min_abund) & (counts <= max_abund)
        _tofile_checked(arr[idx[keep]], out_path)
        return int(keep.sum())
    kept = lib.em_dedup_count_u64(
        in_path.encode(), out_path.encode(), int(min_abund), int(max_abund)
    )
    if kept < 0:
        raise RuntimeError("em_dedup_count_u64 failed")
    return int(kept)


def em_sort_records_file(in_path: str, out_path: str, tmp_dir: str, n_words: int,
                         ram_bytes: int = 1 << 30, n_threads: int = 4) -> None:
    """Sort fixed-size records of n_words uint64 each, lexicographic by
    word (== colex k-mer order for the kmers_wide packing)."""
    if n_words == 1:
        return em_sort_u64_file(in_path, out_path, tmp_dir, ram_bytes, n_threads)
    lib = get_lib()
    if lib is None:
        arr = np.fromfile(in_path, dtype=np.uint64).reshape(-1, n_words)
        order = np.lexsort([arr[:, w] for w in range(n_words - 1, -1, -1)])
        np.ascontiguousarray(arr[order]).tofile(out_path)
        return
    rc = lib.em_sort_u64w(
        in_path.encode(), out_path.encode(), tmp_dir.encode(),
        int(ram_bytes), int(n_threads), int(n_words),
    )
    if rc != 0:
        raise RuntimeError(f"em_sort_u64w failed with code {rc}")


def em_sort_varlen_file(in_path: str, out_path: str, tmp_dir: str,
                        ram_bytes: int = 1 << 30, n_threads: int = 4) -> None:
    """Sort a file of variable-length records (u64 LE payload length +
    payload bytes) in bytewise-lexicographic payload order, matching the
    reference's EM_sort_variable_length_records capability
    (EM_sort.cpp:195-212)."""
    lib = get_lib()
    if lib is None:
        recs = read_varlen_records(in_path)
        recs.sort()
        write_varlen_records(out_path, recs)
        return
    rc = lib.em_sort_varlen(
        in_path.encode(), out_path.encode(), tmp_dir.encode(),
        int(ram_bytes), int(n_threads),
    )
    if rc != 0:
        raise RuntimeError(f"em_sort_varlen failed with code {rc}")


def read_varlen_records(path: str) -> list[bytes]:
    """Read all length-prefixed records of a varlen file (host helper)."""
    import struct

    recs = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if not hdr:
                break
            if len(hdr) != 8:
                raise IOError("truncated varlen record header")
            (ln,) = struct.unpack("<Q", hdr)
            payload = f.read(ln)
            if len(payload) != ln:
                raise IOError("truncated varlen record payload")
            recs.append(payload)
    return recs


def write_varlen_records(path: str, recs: list[bytes]) -> None:
    import struct

    with open(path, "wb") as f:
        for r in recs:
            f.write(struct.pack("<Q", len(r)))
            f.write(r)


def em_dedup_count_records_file(in_path: str, out_path: str, n_words: int,
                                min_abund: int = 1, max_abund: int = 2**62,
                                ram_bytes: int | None = None) -> int:
    """Dedup + abundance-filter a sorted record file (n_words uint64 each)."""
    if n_words == 1:
        return em_dedup_count_u64_file(in_path, out_path, min_abund, max_abund,
                                       ram_bytes=ram_bytes)
    lib = get_lib()
    if lib is None:
        arr = np.fromfile(in_path, dtype=np.uint64).reshape(-1, n_words)
        new = np.empty(len(arr), dtype=bool)
        if len(arr):
            new[0] = True
            new[1:] = np.any(arr[1:] != arr[:-1], axis=1)
            starts = np.flatnonzero(new)
            counts = np.diff(np.concatenate([starts, [len(arr)]]))
            keep = (counts >= min_abund) & (counts <= max_abund)
            np.ascontiguousarray(arr[starts[keep]]).tofile(out_path)
            return int(keep.sum())
        arr.tofile(out_path)
        return 0
    kept = lib.em_dedup_count_u64w(
        in_path.encode(), out_path.encode(), int(min_abund), int(max_abund),
        int(n_words),
    )
    if kept < 0:
        raise RuntimeError("em_dedup_count_u64w failed")
    return int(kept)


def em_sort_dedup_records_file(
    in_path: str, out_path: str, tmp_dir: str, n_words: int,
    ram_bytes: int = 1 << 30, n_threads: int = 4,
    min_abund: int = 1, max_abund: int = 2**62,
) -> int:
    """Fused sort + dedup + abundance cutoff of a record file.

    When the records fit the RAM budget, the whole thing runs in memory
    with NO intermediate sorted file (the split path writes the sorted
    128 MB-class stream to disk only for dedup to read it straight back).
    Out-of-core inputs fall back to the two-stage native path."""
    size = os.path.getsize(in_path)
    if n_words == 1 and (get_lib() is None or size <= ram_bytes // 2):
        arr = np.fromfile(in_path, dtype=np.uint64)
        arr.sort()
        if len(arr) == 0:
            open(out_path, "wb").close()
            return 0
        change = np.empty(len(arr), dtype=bool)
        change[0] = True
        np.not_equal(arr[1:], arr[:-1], out=change[1:])
        n_runs = int(change.sum())
        if n_runs == len(arr):
            # every record distinct (the common genomic-window case):
            # all counts are 1, so skip the run-boundary materialization
            # (flatnonzero + append + diff + fancy index ≈ 1 s at 16M)
            if min_abund <= 1 <= max_abund:
                _tofile_checked(arr, out_path)
                return len(arr)
            open(out_path, "wb").close()
            return 0
        idx = np.flatnonzero(change)
        counts = np.diff(np.append(idx, len(arr)))
        keep = (counts >= min_abund) & (counts <= max_abund)
        _tofile_checked(arr[idx[keep]], out_path)
        return int(keep.sum())
    sorted_f = os.path.join(tmp_dir, os.path.basename(in_path) + ".sorted")
    em_sort_records_file(in_path, sorted_f, tmp_dir, n_words,
                         ram_bytes=ram_bytes, n_threads=n_threads)
    try:
        return em_dedup_count_records_file(
            sorted_f, out_path, n_words, min_abund=min_abund,
            max_abund=max_abund, ram_bytes=ram_bytes,
        )
    finally:
        try:
            os.remove(sorted_f)
        except OSError:
            pass


def spill_windows_u64(codes: np.ndarray, k: int, path: str, n_threads: int = 4) -> int | None:
    """Pack every valid k-window of `codes` (int8) and APPEND the uint64
    records to `path` — the external build's spill-encode stage in one
    native pass (rolling update, multithreaded).  Returns the record
    count, or None when the native library is unavailable (caller falls
    back to utils/kmers.pack_windows)."""
    if k > 32:
        return None
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    n = lib.pk_spill_windows_u64(
        codes.ctypes.data, len(codes), int(k), path.encode(), int(n_threads)
    )
    if n < 0:
        raise RuntimeError(f"spill_windows_u64 failed writing {path}")
    return int(n)


def pack_windows_u64(codes: np.ndarray, k: int):
    """Native pack_windows (utils/kmers.py contract): returns
    (vals uint64 [m], valid bool [m]) or None when unavailable."""
    if k > 32:
        return None
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    n = len(codes)
    if n < k:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool)
    m = n - k + 1
    vals = np.empty(m, dtype=np.uint64)
    valid = np.empty(m, dtype=np.uint8)
    lib.pk_pack_windows_u64(
        codes.ctypes.data, n, int(k), vals.ctypes.data, valid.ctypes.data
    )
    return vals, valid.astype(bool)


def merge_isin_u64(sorted_vals: np.ndarray, sorted_queries: np.ndarray):
    """Membership of SORTED queries in a sorted uint64 array via one
    linear merge pass; None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(sorted_vals, dtype=np.uint64)
    q = np.ascontiguousarray(sorted_queries, dtype=np.uint64)
    found = np.empty(len(q), dtype=np.uint8)
    cov = np.empty(len(a), dtype=np.uint8)  # scratch; coverage unused
    lib.pk_merge_probe(
        a.ctypes.data, len(a), q.ctypes.data, len(q),
        found.ctypes.data, cov.ctypes.data,
    )
    return found.astype(bool)
