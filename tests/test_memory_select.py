"""Capacity-aware turbo tier selection (degrade 3 -> 2 -> LF, never OOM)
and the mef-concat compressed-L disk design point."""
import numpy as np
import pytest

from sbwt_tpu.models.sbwt import SBWT
from sbwt_tpu.utils.memory import (
    device_free_bytes,
    select_turbo_arity,
    turbo_table_bytes,
)


def test_turbo_table_cost_model():
    assert turbo_table_bytes(1_000_000, 2) == 128 * 1_000_000
    assert turbo_table_bytes(1_000_000, 3) == 1024 * 1_000_000


def test_select_turbo_arity_tiers():
    # 100M columns (a big-index scenario): arity 3's flat row
    # index n * 64 overflows int32 past 2^25 columns, so the ladder must
    # skip it here NO MATTER how much device memory is free (ops/turbo.py
    # check_turbo_index_range); arity 2 (1.6e9 rows < 2^31) needs 12.8 GB
    n = 100_000_000
    assert select_turbo_arity(n, free_bytes=300 << 30) == 2
    assert select_turbo_arity(n, free_bytes=30 << 30) == 2
    assert select_turbo_arity(n, free_bytes=2 << 30) is None
    # small index: everything fits
    assert select_turbo_arity(10_000, free_bytes=1 << 30) == 3
    # at 2^26 columns arity 3 overflows but arity 2 (2^30 rows) still fits
    assert select_turbo_arity(1 << 26, free_bytes=300 << 30) == 2


def test_turbo_table_bytes_includes_seed_bitmap():
    # the pair-liveness bitmap (2 bits per (p+1)-mer) is part of the
    # turbo footprint whenever 0 < p <= 14: 4^(p+1)/4 bytes = 67 MB at
    # p=13 — the degrade ladder's budget must account for it
    base = turbo_table_bytes(1_000_000, 2)
    assert turbo_table_bytes(1_000_000, 2, precalc_k=13) == base + 4**14 // 4
    assert turbo_table_bytes(1_000_000, 2, precalc_k=15) == base


def test_select_turbo_arity_measured():
    # with the real measured free memory of this machine, a 100M-column
    # index must resolve to SOME working configuration without raising
    free = device_free_bytes()
    assert free is not None and free > 0
    choice = select_turbo_arity(100_000_000)
    assert choice in (3, 2, None)


def test_enable_turbo_degrades_not_raises():
    sbwt = SBWT.build(["ACGTACGTACGTTAGCATCGAT" * 3], 6, precalc_k=4)
    # plenty of budget -> arity 3
    assert sbwt.enable_turbo(free_bytes=1 << 30) == 3
    # only enough for the pair table (+ seed bitmap) -> arity 2
    n = sbwt.number_of_subsets()
    assert sbwt.enable_turbo(free_bytes=turbo_table_bytes(n, 2, precalc_k=4) * 2) == 2
    # not even that -> LF fallback, turbo disabled, queries still work
    assert sbwt.enable_turbo(free_bytes=64) is None
    assert sbwt._turbo is None
    assert sbwt.streaming_search("ACGTACGTACGT") == [
        sbwt.search("ACGTACGTACGT"[i : i + 6]) for i in range(7)
    ]


def test_mef_concat_disk_smaller_than_plain_concat(tmp_path):
    """variants.hh:43-49 parity: mef-concat's L is compressed on disk
    (Elias-Fano boundary vector), so its native file must be smaller than
    plain-concat's on a realistic corpus."""
    from sbwt_tpu.io.serialize import save, load

    rng = np.random.default_rng(12)
    seqs = ["".join(rng.choice(list("ACGT"), size=4000))]
    plain = SBWT.build(seqs, 8)
    sizes = {}
    for variant in ["plain-concat", "mef-concat"]:
        v = plain.to_variant(variant)
        path = str(tmp_path / f"{variant}.tsbwt")
        sizes[variant] = save(path, v, "native")
        back = load(path)
        assert np.array_equal(back.bits, plain.bits)
        assert back.search(seqs[0][:8]) == plain.search(seqs[0][:8])
    assert sizes["mef-concat"] < sizes["plain-concat"], sizes


def test_select_turbo_arity_wide():
    """Wide (int64) indexes only have the arity-1 pair-row tier, whose
    [n, 8] rows cost 32 B/col — twice the narrow row tier; the ladder
    must account for THAT footprint (round-4 weak item: auto mode could
    pick an arity the wide build silently rerouted)."""
    assert select_turbo_arity(1 << 28, free_bytes=4 << 30, wide=True) is None
    assert select_turbo_arity(1 << 28, free_bytes=20 << 30, wide=True) == 1
    assert select_turbo_arity(1 << 25, free_bytes=4 << 30, wide=True) == 1
    assert turbo_table_bytes(1 << 25, 3, wide=True) == (1 << 25) * 32
