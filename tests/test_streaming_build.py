"""Streaming (bounded-memory) external construction.

Differential against the in-memory oracle with tiny chunk sizes (forcing
every cross-chunk carry: suffix groups, probe cursors, dummy dedup, and
the merge join to straddle chunk boundaries), plus a subprocess test that
builds an index whose distinct k-mer set exceeds ram_bytes under a hard
RLIMIT_AS — the reference's O(1)-memory stream-merge guarantee
(kmc_construct.hh:43-99)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from sbwt_tpu.construct.inmemory import build_sbwt, build_from_kmers
from sbwt_tpu.construct.streaming import build_streaming
from sbwt_tpu.utils import kmers as km
from sbwt_tpu.utils import kmers_wide as kw
from sbwt_tpu.utils.dna import encode
from sbwt_tpu.utils.tempfiles import get_temp_file_manager

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _distinct_file(seqs, k, tmp_path):
    """Sorted distinct k-mer records on disk, as the dedup stage produces."""
    wide = k > km.MAX_K
    mod = kw if wide else km
    chunks = []
    for s in seqs:
        vals, valid = mod.pack_windows(encode(s), k)
        if vals.size:
            chunks.append(vals[valid])
    allv = np.concatenate(chunks)
    if wide:
        uniq, _ = kw.unique_rows_sorted(allv)
    else:
        uniq = np.unique(allv)
    path = str(tmp_path / f"distinct_{k}.bin")
    np.ascontiguousarray(uniq).astype(np.uint64).tofile(path)
    return path, len(uniq)


@pytest.mark.parametrize("k,chunk", [(4, 3), (4, 7), (13, 5), (13, 64), (31, 17)])
def test_streaming_equals_inmemory_tiny_chunks(k, chunk, tmp_path):
    rng = np.random.default_rng(k * 100 + chunk)
    seqs = ["".join(rng.choice(list("ACGT"), size=400)) for _ in range(3)]
    seqs += ["ACGT" * 40, "A" * 50]  # cyclic + single-letter stress
    oracle = build_sbwt(seqs, k)
    path, n = _distinct_file(seqs, k, tmp_path)
    tfm = get_temp_file_manager()
    tfm.set_dir(str(tmp_path))
    got = build_streaming(path, n, k, True, 1 << 20, 2, tfm, chunk_records=chunk)
    np.testing.assert_array_equal(oracle.bits, got.bits)
    np.testing.assert_array_equal(oracle.suffix_group_starts, got.suffix_group_starts)
    assert oracle.n_kmers == got.n_kmers


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_streaming_equal_value_dummy_groups_across_chunks(chunk, tmp_path):
    """Regression: dummy groups sharing a packed VALUE at different
    lengths ('A', 'AA', 'AAAA' all pack to 0) must still be emitted before
    equal-valued k-mers even when the dedup stream's carry splits them
    across chunks — with chunk_records=1 every carry path is exercised."""
    seqs = ["AATGGTATCAC", "TTGA", "AAACACG", "AAAAC"]
    k = 4
    oracle = build_sbwt(seqs, k)
    path, n = _distinct_file(seqs, k, tmp_path)
    tfm = get_temp_file_manager()
    tfm.set_dir(str(tmp_path))
    got = build_streaming(path, n, k, True, 1 << 20, 1, tfm, chunk_records=chunk)
    np.testing.assert_array_equal(oracle.bits, got.bits)
    np.testing.assert_array_equal(oracle.suffix_group_starts, got.suffix_group_starts)


def test_streaming_wide_equal_value_duplicates(tmp_path):
    """Regression for the wide path: duplicate-value rows inside one dummy
    buffer (prefixes 'C' and 'AC' pad to equal rows) must all be counted
    by the right-side row search."""
    base = "".join(np.random.default_rng(1).choice(list("ACGT"), size=80))
    seqs = ["C" + base, "AC" + base[:70], "A" * 45, "AC" + "A" * 43 + "G"]
    k = 40
    oracle = build_sbwt(seqs, k)
    path, n = _distinct_file(seqs, k, tmp_path)
    tfm = get_temp_file_manager()
    tfm.set_dir(str(tmp_path))
    for chunk in (1, 5):
        got = build_streaming(path, n, k, True, 1 << 20, 1, tfm, chunk_records=chunk)
        np.testing.assert_array_equal(oracle.bits, got.bits)
        np.testing.assert_array_equal(oracle.suffix_group_starts, got.suffix_group_starts)


@pytest.mark.parametrize("k", [40, 70])
def test_streaming_wide_kmers(k, tmp_path):
    rng = np.random.default_rng(k)
    seqs = ["".join(rng.choice(list("ACGT"), size=300)) for _ in range(2)]
    oracle = build_sbwt(seqs, k)
    path, n = _distinct_file(seqs, k, tmp_path)
    tfm = get_temp_file_manager()
    tfm.set_dir(str(tmp_path))
    got = build_streaming(path, n, k, True, 1 << 20, 2, tfm, chunk_records=19)
    np.testing.assert_array_equal(oracle.bits, got.bits)
    np.testing.assert_array_equal(oracle.suffix_group_starts, got.suffix_group_starts)


def test_streaming_empty_input(tmp_path):
    path = str(tmp_path / "empty.bin")
    open(path, "wb").close()
    tfm = get_temp_file_manager()
    tfm.set_dir(str(tmp_path))
    got = build_streaming(path, 0, 6, True, 1 << 20, 1, tfm)
    oracle = build_from_kmers(np.empty(0, dtype=np.uint64), 6)
    np.testing.assert_array_equal(oracle.bits, got.bits)


_RLIMIT_SCRIPT = textwrap.dedent(
    """
    import resource, sys
    import numpy as np
    limit = int(sys.argv[1])
    resource.setrlimit(resource.RLIMIT_AS, (limit, limit))
    from sbwt_tpu.construct.external import build_sbwt_external
    rng = np.random.default_rng(0)
    # ~4M distinct 20-mers => 32 MB of packed records, >> ram_bytes
    seqs = ["".join(rng.choice(list("ACGT"), size=1 << 16)) for _ in range(64)]
    built = build_sbwt_external(
        seqs, 20, ram_bytes=4 << 20, n_threads=2, temp_dir=sys.argv[2]
    )
    np.savez(sys.argv[3], packed=built.bits_packed, n=built.n_cols,
             sgs=built.sgs_packed, n_kmers=built.n_kmers)
    """
)


@pytest.mark.slow
def test_streaming_build_under_rlimit(tmp_path):
    """Distinct set (~32 MB of records) exceeds ram_bytes (4 MB); the build
    must complete inside a hard address-space cap and match the in-memory
    oracle bit-for-bit."""
    out = str(tmp_path / "result.npz")
    script = str(tmp_path / "rl_build.py")
    with open(script, "w") as f:
        f.write(_RLIMIT_SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT
    # 400 MB total address space (tightened from round 2's 512 MB now that
    # the build emits packed rows end-to-end): the in-memory pipeline on
    # the same input ArrayMemoryErrors even at 900 MB.
    limit = 400 * (1 << 20)
    proc = subprocess.run(
        [sys.executable, script, str(limit), str(tmp_path), out],
        capture_output=True,
        text=True,
        env=env,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    data = np.load(out)
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("ACGT"), size=1 << 16)) for _ in range(64)]
    from sbwt_tpu.construct.inmemory import build_sbwt as build_mem

    oracle = build_mem(seqs, 20)
    n = int(data["n"])
    assert n == oracle.bits.shape[1]
    np.testing.assert_array_equal(
        np.packbits(oracle.bits, axis=1, bitorder="little"), data["packed"]
    )
    np.testing.assert_array_equal(
        np.packbits(oracle.suffix_group_starts, bitorder="little"), data["sgs"]
    )


_INPUT_RLIMIT_SCRIPT = textwrap.dedent(
    """
    import resource, sys
    import numpy as np
    limit = int(sys.argv[1])
    resource.setrlimit(resource.RLIMIT_AS, (limit, limit))
    from sbwt_tpu.construct.external import build_sbwt_external
    from sbwt_tpu.io.seqio import stream_build_codes
    built = build_sbwt_external(
        stream_build_codes([sys.argv[4]]),
        20, ram_bytes=32 << 20, n_threads=2, temp_dir=sys.argv[2],
    )
    np.savez(sys.argv[3], packed=built.bits_packed, n=built.n_cols,
             sgs=built.sgs_packed, n_kmers=built.n_kmers)
    """
)


@pytest.mark.slow
def test_input_side_streaming_under_rlimit(tmp_path):
    """The CLI build's INPUT side must stream: a FASTA bigger than the
    address-space headroom builds fine through stream_build_codes ->
    external spill (the reference never holds the corpus either,
    kmc_construct.hh:206-238).  Materializing the corpus (bytes + int8
    codes ~= 2x file size) would blow the cap; the streaming path holds
    one bounded batch at a time."""
    rng = np.random.default_rng(5)
    fasta = str(tmp_path / "big.fna")
    n_seqs, seq_len = 200, 1 << 20  # ~200 MB of bases -> >200M columns
    with open(fasta, "wb") as f:
        for i in range(n_seqs):
            f.write(b">s%d\n" % i)
            f.write(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                               size=seq_len).tobytes())
            f.write(b"\n")
    out = str(tmp_path / "result.npz")
    script = str(tmp_path / "rl_input.py")
    with open(script, "w") as f:
        f.write(_INPUT_RLIMIT_SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT
    # python+numpy baseline ~165 MB; packed output rows at ~150M columns
    # are ~100 MB; 360 MB total leaves well under 1x the file size of
    # headroom, so corpus materialization (bytes + codes = 2x file size,
    # ~300 MB) cannot fit.  (The cap is address space, not RSS: glibc
    # thread arenas in the native sorter reserve VA beyond the touched
    # pages, hence the headroom over the ~270 MB measured RSS.)
    limit = 460 * (1 << 20)
    # -S keeps the site module's .pth imports out of the capped
    # interpreter (without it the address space they take leaves the
    # build no room under this cap); site-packages goes in via PYTHONPATH
    import sysconfig

    env["PYTHONPATH"] = _ROOT + os.pathsep + sysconfig.get_paths()["purelib"]
    # glibc per-thread arenas in the native sorter reserve VA that never
    # returns; one arena keeps RLIMIT_AS meaningful for the python side
    env["MALLOC_ARENA_MAX"] = "1"
    proc = subprocess.run(
        [sys.executable, "-S", script, str(limit), str(tmp_path), out, fasta],
        capture_output=True, text=True, env=env, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    data = np.load(out)
    # sanity, not a full oracle (the bit-exactness of the streaming build
    # is covered by the differential tests above): random 150 Mbp at k=20
    # has ~150M distinct k-mers and every column one of ~4 subsets
    assert int(data["n_kmers"]) > 150_000_000
    assert int(data["n"]) > 200_000_000  # packed build at >=200M columns
    assert int(data["n"]) > int(data["n_kmers"])
