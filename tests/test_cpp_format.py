"""cpp `.sbwt` interchange format: sdsl codec semantics + 10-variant roundtrip.

The sdsl payloads must be *semantically* valid, not merely round-trippable:
for each codec a "replica" function answers rank/select the way the C++
side would, reading only the serialized fields, and is checked against a
plain numpy oracle.  This mirrors what the reference's own serialization
tests assert (tests/test_small.hh:324-429) and extends it to byte level.
"""
import io
import itertools
import os
import textwrap

import numpy as np
import pytest

from sbwt_tpu.io import sdsl
from sbwt_tpu.io import serialize as ser
from sbwt_tpu.models.sbwt import SBWT, VARIANT_NAMES
from sbwt_tpu.utils.dna import encode_query

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZES = [0, 1, 63, 64, 65, 383, 384, 385, 511, 512, 513, 2047, 2048, 2049, 5000]


def _random_bits(rng, n, density):
    return rng.random(n) < density


# ---------------------------------------------------------------------------
# int_vector framing
# ---------------------------------------------------------------------------

def test_int_vector0_roundtrip():
    rng = np.random.default_rng(1)
    for width in [1, 3, 6, 11, 17, 31, 40, 63, 64]:
        vals = rng.integers(0, 2 ** min(width, 62), size=37, dtype=np.int64)
        buf = io.BytesIO()
        sdsl.write_int_vector0(buf, vals, width)
        buf.seek(0)
        back, w = sdsl.read_int_vector0(buf)
        assert w == width
        assert back.astype(np.int64).tolist() == vals.tolist()
        assert buf.read() == b""


# ---------------------------------------------------------------------------
# rank_support_v / rank_support_v5 payload semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["v", "v5"])
def test_rank_support_replica_matches_oracle(family):
    payload_fn = sdsl.rank_v_payload if family == "v" else sdsl.rank_v5_payload
    replica = sdsl.rank_v_replica if family == "v" else sdsl.rank_v5_replica
    rng = np.random.default_rng(2)
    for n in SIZES:
        for density in [0.0, 0.05, 0.5, 1.0]:
            bits = _random_bits(rng, n, density)
            payload = payload_fn(bits)
            words = sdsl.bits_to_words(bits)
            cums = np.concatenate([[0], np.cumsum(bits)])
            if n <= 600:
                positions = range(n + 1)
            else:
                positions = sorted(
                    set(
                        rng.integers(0, n + 1, size=80).tolist()
                        + [0, 1, 63, 64, 383, 384, 511, 512, 2047 % (n + 1), n - 1, n]
                    )
                )
            for idx in positions:
                assert replica(payload, words, idx) == cums[idx], (family, n, density, idx)


def test_rank_support_payload_sizing():
    # empty bit vector -> 2 zero words; capacity-based superblock count
    assert sdsl.rank_v5_payload(np.zeros(0, dtype=bool)).tolist() == [0, 0]
    assert len(sdsl.rank_v5_payload(np.zeros(2040, dtype=bool))) == 4  # cap 2048
    assert len(sdsl.rank_v5_payload(np.zeros(2049, dtype=bool))) == 4
    assert len(sdsl.rank_v_payload(np.zeros(512, dtype=bool))) == 4


# ---------------------------------------------------------------------------
# select_support_mcl
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [0, 1])
def test_select_mcl_replica(b):
    rng = np.random.default_rng(3)
    cases = [
        _random_bits(rng, 1000, 0.3),
        _random_bits(rng, 5000, 0.9),
        np.ones(100, dtype=bool),
        np.zeros(100, dtype=bool),
    ]
    # force a long superblock: few args spread over a wide vector
    sparse = np.zeros(1 << 20, dtype=bool)
    sparse[[0, 500_000, 1_000_000 - 1]] = b == 1
    if b == 0:
        sparse = ~sparse
    cases.append(sparse if b == 1 else ~sparse)
    for bits in cases:
        buf = io.BytesIO()
        sdsl.write_select_mcl(buf, bits, b)
        buf.seek(0)
        fl = sdsl.read_select_mcl(buf)
        assert buf.read() == b""
        args = np.flatnonzero(bits == bool(b))
        assert fl["arg_cnt"] == len(args)
        if len(args) == 0:
            continue
        take = range(1, len(args) + 1) if len(args) < 300 else sorted(
            set([1, 2, len(args)] + np.random.default_rng(4).integers(
                1, len(args) + 1, size=64).tolist())
        )
        for i in take:
            assert sdsl.select_mcl_replica(fl, bits, b, i) == args[i - 1]


def test_select_mcl_long_block_encoding():
    bits = np.zeros(1 << 20, dtype=bool)
    bits[[0, 500_000, 1_000_000 - 1]] = True
    fl = sdsl.select_mcl_fields(bits, 1)
    assert fl["long_flags"].any()  # span exceeds logn^4 -> long superblock


# ---------------------------------------------------------------------------
# rrr_vector<63>
# ---------------------------------------------------------------------------

def test_rrr_nr_bin_inverse():
    rng = np.random.default_rng(5)
    for _ in range(200):
        v = int(rng.integers(0, 1 << 62)) | (int(rng.integers(0, 2)) << 62)
        v &= (1 << 63) - 1
        k = bin(v).count("1")
        assert sdsl.rrr_nr_to_bin(k, sdsl.rrr_bin_to_nr(v)) == v
    assert sdsl.rrr_bin_to_nr(0) == 0
    assert sdsl.rrr_bin_to_nr((1 << 63) - 1) == 0
    # enumeration is dense: for a given k, nr < C(63, k)
    for k in [1, 2, 31, 62]:
        v = sum(1 << i for i in range(k))  # smallest-position combination
        assert sdsl.rrr_bin_to_nr(v) < sdsl._C63[k]


@pytest.mark.parametrize("density", [0.05, 0.5, 0.92])
def test_rrr_roundtrip_and_rank(density):
    rng = np.random.default_rng(6)
    for n in [0, 1, 62, 63, 64, 126, 2016, 2017, 5000]:
        bits = _random_bits(rng, n, density)
        buf = io.BytesIO()
        sdsl.write_rrr(buf, bits)
        buf.seek(0)
        fields = sdsl.read_rrr_fields(buf)
        assert buf.read() == b""
        assert np.array_equal(sdsl.rrr_decode(fields), bits)
        cums = np.concatenate([[0], np.cumsum(bits)])
        positions = range(n + 1) if n <= 200 else sorted(
            set(rng.integers(0, n + 1, size=60).tolist() + [0, n, 2016 % (n + 1)])
        )
        for idx in positions:
            assert sdsl.rrr_rank_replica(fields, idx) == cums[idx], (n, density, idx)


def test_rrr_dense_uses_inversion():
    rng = np.random.default_rng(7)
    bits = _random_bits(rng, 4032, 0.95)  # two full superblocks, dense
    enc = sdsl.rrr_encode(bits)
    assert enc["invert"].any()


# ---------------------------------------------------------------------------
# sd_vector
# ---------------------------------------------------------------------------

def test_sd_roundtrip():
    rng = np.random.default_rng(8)
    for n in [1, 64, 1000, 5000]:
        for density in [0.0, 0.01, 0.3, 1.0]:
            bits = _random_bits(rng, n, density)
            buf = io.BytesIO()
            sdsl.write_sd(buf, bits)
            buf.seek(0)
            back = sdsl.read_sd(buf)
            assert buf.read() == b""
            assert np.array_equal(back, bits), (n, density)


# ---------------------------------------------------------------------------
# mod_ef_vector (MEF.hpp)
# ---------------------------------------------------------------------------

def test_mef_roundtrip_and_rank():
    rng = np.random.default_rng(9)
    for n in [0, 1, 63, 64, 100, 1000, 4096, 10000]:
        for density in [0.0, 0.02, 0.3, 1.0]:
            bits = _random_bits(rng, n, density)
            buf = io.BytesIO()
            sdsl.write_mef(buf, bits)
            buf.seek(0)
            enc = sdsl.read_mef_fields(buf)
            assert buf.read() == b""
            assert np.array_equal(sdsl.mef_decode(enc), bits), (n, density)
            cums = np.concatenate([[0], np.cumsum(bits)])
            positions = range(n + 1) if n <= 200 else sorted(
                set(rng.integers(0, n + 1, size=40).tolist() + [0, n])
            )
            for idx in positions:
                assert sdsl.mef_rank_replica(enc, idx) == cums[idx], (n, density, idx)


def test_mef_optimize_w_prefers_wide_buckets_for_sparse():
    rng = np.random.default_rng(10)
    sparse = _random_bits(rng, 1 << 14, 0.004)
    dense = _random_bits(rng, 1 << 14, 0.5)
    assert sdsl.mef_optimize_w(sparse) > sdsl.mef_optimize_w(dense)


# ---------------------------------------------------------------------------
# wt_blcd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compressed", [False, True])
def test_wt_roundtrip_and_rank(compressed):
    rng = np.random.default_rng(11)
    alphabets = [b"A", b"AC", b"ACG", b"ACGT", b"$ACGT", b"0123"]
    for alpha in alphabets:
        for n in [0, 1, 17, 500]:
            text = np.frombuffer(
                bytes(rng.choice(list(alpha), size=n)), dtype=np.uint8
            )
            buf = io.BytesIO()
            sdsl.write_wt_blcd(buf, text, compressed=compressed)
            buf.seek(0)
            enc = sdsl.read_wt_fields(buf, compressed=compressed)
            assert buf.read() == b""
            assert np.array_equal(sdsl.wt_decode(enc), text), (alpha, n)
            for c in set(alpha) | {ord("T")}:
                cums = np.concatenate([[0], np.cumsum(text == c)])
                for i in sorted(set([0, n // 3, n // 2, n])):
                    assert sdsl.wt_rank_replica(enc, i, c) == cums[i], (alpha, n, c, i)


# ---------------------------------------------------------------------------
# Full index roundtrips: all 10 variants through the cpp format
# ---------------------------------------------------------------------------

STRINGS = ["CCCGTGATGGCTA", "TAATGCTGTAGC", "TGGCTCGTGTAGTCGA", "ACACAGT"]
K = 4


@pytest.fixture(scope="module")
def plain_index():
    return SBWT.build(STRINGS, K, precalc_k=2)


@pytest.fixture(scope="module")
def all_codes():
    kmers = ["".join(t) for t in itertools.product("ACGT", repeat=K)]
    return np.stack([encode_query(s) for s in kmers])


@pytest.mark.parametrize("variant", VARIANT_NAMES)
def test_cpp_roundtrip_all_variants(tmp_path, variant, plain_index, all_codes):
    v = plain_index.to_variant(variant)
    path = str(tmp_path / f"{variant}.sbwt")
    ser.save(path, v, "cpp")
    back = ser.load(path)
    assert back.variant == variant
    assert back.k == K
    assert back.number_of_kmers() == plain_index.number_of_kmers()
    assert back.get_precalc_k() == 2
    assert np.array_equal(back.bits, plain_index.bits)
    assert np.array_equal(back.suffix_group_starts, plain_index.suffix_group_starts)
    assert np.array_equal(back.search_batch(all_codes), plain_index.search_batch(all_codes))
    for s in STRINGS:
        assert back.streaming_search(s) == plain_index.streaming_search(s)


def test_cpp_compressed_variants_are_smaller(tmp_path):
    """The compressed cpp payloads must actually compress (the raison
    d'etre of the variant families) once fixed overheads are amortized."""
    rng = np.random.default_rng(42)
    seqs = ["".join(rng.choice(list("ACGT"), size=5000))]
    big = SBWT.build(seqs, 8)
    sizes = {}
    for variant in ["plain-matrix", "rrr-matrix"]:
        path = str(tmp_path / f"size_{variant}.sbwt")
        sizes[variant] = ser.save(path, big.to_variant(variant), "cpp")
    assert sizes["rrr-matrix"] < sizes["plain-matrix"]


def test_cpp_format_empty_rows_and_missing_letters(tmp_path, all_codes):
    # alphabet gaps exercise sigma<4 wavelet trees and empty Z/Y paths
    idx = SBWT.build(["AAAACCCCAAAA"], K)
    for variant in VARIANT_NAMES:
        v = idx.to_variant(variant)
        path = str(tmp_path / f"gap_{variant}.sbwt")
        ser.save(path, v, "cpp")
        back = ser.load(path)
        assert np.array_equal(back.bits, idx.bits)
        assert np.array_equal(back.search_batch(all_codes), idx.search_batch(all_codes))


# ---------------------------------------------------------------------------
# Golden fixture: hand-assembled plain-matrix byte stream
# ---------------------------------------------------------------------------

def _expected_plain_matrix_bytes(sbwt) -> bytes:
    """Assemble the expected byte stream independently of save_cpp, field
    by field, following the documented layout (docs/SDSL_LAYOUT.md):
    variant tag, "v0.1", 4x (bit_vector + rank_support_v5), sgs, C,
    precalc pairs, 4 raw int64 scalars."""
    out = bytearray()

    def string(s):
        out.extend(len(s).to_bytes(8, "little"))
        out.extend(s.encode())

    def bitvec(bools):
        n = len(bools)
        out.extend(n.to_bytes(8, "little"))
        acc = 0
        for i, b in enumerate(bools):
            if b:
                acc |= 1 << i
        for w in range((n + 63) // 64):
            out.extend(((acc >> (64 * w)) & ((1 << 64) - 1)).to_bytes(8, "little"))

    def rank_v5(bools):
        n = len(bools)
        cap_words = (n + 63) // 64
        nsb = cap_words // 32 + 1
        out.extend((2 * nsb * 64).to_bytes(8, "little"))
        cums = np.concatenate([[0], np.cumsum(np.pad(bools, (0, nsb * 2048 - n)))])
        for s in range(nsb):
            out.extend(int(cums[min(32 * 64 * s, cap_words * 64)]).to_bytes(8, "little"))
            rel = 0
            for m in range(1, 6):
                if 32 * s + 6 * m <= cap_words:
                    cnt = int(cums[(32 * s + 6 * m) * 64] - cums[min(32 * 64 * s, cap_words * 64)])
                    rel |= cnt << (63 - 11 * m)
            out.extend(rel.to_bytes(8, "little"))

    string(sbwt.variant)
    string("v0.1")
    for c in range(4):
        bitvec(sbwt.bits[c])
    for c in range(4):
        rank_v5(sbwt.bits[c])
    bitvec(sbwt.suffix_group_starts)
    C = np.asarray(sbwt.device_index.C, dtype=np.int64)
    out.extend((8 * len(C)).to_bytes(8, "little"))
    out.extend(C.astype("<i8").tobytes())
    pairs = (
        np.asarray(sbwt.device_index.precalc, dtype=np.int64)
        if sbwt.get_precalc_k() > 0
        else np.empty((0, 2), dtype=np.int64)
    )
    out.extend((pairs.size * 8).to_bytes(8, "little"))
    out.extend(pairs.astype("<i8").tobytes())
    for v in [sbwt.get_precalc_k(), sbwt.number_of_subsets(), sbwt.number_of_kmers(), sbwt.k]:
        out.extend(int(v).to_bytes(8, "little", signed=True))
    return bytes(out)


def test_plain_matrix_golden_bytes(tmp_path, plain_index):
    path = str(tmp_path / "golden.sbwt")
    ser.save(path, plain_index, "cpp")
    with open(path, "rb") as f:
        got = f.read()
    assert got == _expected_plain_matrix_bytes(plain_index)


_WIDE_ROUNDTRIP = textwrap.dedent(
    """
    import resource, sys
    import numpy as np
    # 30 GB address-space cap: the packed save/load path peaks ~14 GB
    # (packed rows 2.7 GB + cpu-backend rank tables ~8 GB + windowed
    # build transients); a bool-matrix path would add 17 GB of bit rows
    # + 4.3 GB of sgs bools on top (> 34 GB) and cannot fit.
    cap = 30 << 30
    resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sbwt_tpu.models.sbwt import SBWT
    from sbwt_tpu.models.wide import WideMatrixIndex
    from sbwt_tpu.io.serialize import save_cpp, load
    from sbwt_tpu.ops import search as engines

    K = 16
    NK = 4 ** K
    N = NK + 1
    W = N // 32 + 1
    # complete order-16 DBG pattern (tests/test_wide_index.py, self-checked
    # there against the real constructor at k=8)
    row = np.full(W, 0x22222222, dtype=np.uint32)
    row[-1] = 0
    sgs = row.copy()
    sgs[0] = 0x22222223
    packed = np.stack([row] * 4).view(np.uint8).reshape(4, -1)[:, : (N + 7) // 8]
    sgs_packed = sgs.view(np.uint8)[: (N + 7) // 8]

    sbwt = SBWT.from_packed(packed, N, sgs_packed, k=K, n_kmers=NK, precalc_k=2)
    assert isinstance(sbwt.device_index, WideMatrixIndex)
    path = sys.argv[1]
    save_cpp(path, sbwt)
    del sbwt

    loaded = load(path)
    assert isinstance(loaded.device_index, WideMatrixIndex)
    assert loaded.number_of_subsets() == N and loaded.number_of_kmers() == NK

    rng = np.random.default_rng(0)
    pows = 4 ** np.arange(K, dtype=np.int64)
    qs = rng.integers(0, 4, size=(2048, K)).astype(np.int8)
    qs[0, :] = 0
    qs[1, :] = 3
    got = np.asarray(engines.search_jit(loaded.device_index, jnp.asarray(qs)))
    want = 1 + (qs.astype(np.int64) * pows).sum(axis=-1)
    assert want.max() > 2**31
    assert np.array_equal(got, want), (got[:4], want[:4])
    print("WIDE-ROUNDTRIP-OK")
    """
)


@pytest.mark.slow
def test_cpp_roundtrip_wide_scale(tmp_path):
    """save_cpp + load of a 4.29-billion-column index under a host
    address-space cap that a bool-matrix transient would blow: the
    chunked packed path keeps cpp export/import usable at wide-engine
    scale, spot-checked by the complete-DBG closed-form oracle."""
    import subprocess
    import sys

    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    out = str(tmp_path / "wide.sbwt")
    proc = subprocess.run(
        [sys.executable, "-c", _WIDE_ROUNDTRIP, out],
        capture_output=True, text=True, env=env, timeout=3000,
    )
    assert proc.returncode == 0 and "WIDE-ROUNDTRIP-OK" in proc.stdout, (
        proc.stderr[-4000:]
    )


def test_truncated_cpp_file_reports_structure_and_offset(tmp_path):
    """A truncated/corrupted .sbwt file must fail with a named structure
    and byte offset (CppFormatError), not a bare struct.unpack crash —
    first contact with real C++-written files must be debuggable."""
    from sbwt_tpu.io.serialize import CppFormatError, save_cpp

    sb = SBWT.build(["ACGTACGTAGCTAGCTACGATCGATCG"], 6, precalc_k=2)
    path = tmp_path / "ok.sbwt"
    n_total = save_cpp(str(path), sb)
    data = path.read_bytes()
    # truncate inside the 3rd bit vector: past tag+version+2 rows
    for cut in (len(data) // 3, len(data) // 2, len(data) - 9):
        bad = tmp_path / f"cut{cut}.sbwt"
        bad.write_bytes(data[:cut])
        with bad.open("rb") as f:
            with pytest.raises(CppFormatError) as ei:
                ser.load_cpp_stream(f)
        msg = str(ei.value)
        assert "byte offset" in msg or "columns" in msg, msg
    # flip a SET bit inside the A row's data words (tag 20B + version 12B +
    # count 8B = data at 40): clearing a real 1-bit changes the recomputed
    # C array, which the load must catch
    bad = bytearray(data)
    flip_at = next(i for i in range(40, 48) if bad[i])
    bad[flip_at] &= bad[flip_at] - 1  # clear lowest set bit
    p2 = tmp_path / "flip.sbwt"
    p2.write_bytes(bytes(bad))
    with p2.open("rb") as f:
        with pytest.raises(CppFormatError):
            ser.load_cpp_stream(f)
