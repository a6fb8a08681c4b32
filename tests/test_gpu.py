"""Tests that need a GPU (marker `gpu`; the fixtures skip them elsewhere).

Run on a GPU machine with `python -m pytest tests/ -m gpu`.  Each checks
an engine on the card against a path that does not share its code, at
the size the benchmark and chip_smoke.py use.
"""
import io
import os
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_module(name):
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    return __import__(name)


def test_turbo_auto_matches_lf_at_bench_size(gpu_device):
    """The adaptive turbo engine (what `search --engine auto` runs) must
    answer exactly like the LF engine on the bench's index and batch, in
    the hit-heavy and the all-miss regime, one after the other."""
    import jax.numpy as jnp

    from sbwt_tpu.models.sbwt import SBWT
    from sbwt_tpu.ops.search import streaming_search_jit
    from sbwt_tpu.ops.turbo import AdaptiveTurboEngine

    bench = _root_module("bench")
    genome = bench.make_corpus_codes()
    sb = SBWT.build([genome], bench.K, precalc_k=13)
    assert sb.enable_turbo() is not None
    eng = AdaptiveTurboEngine(sb._turbo, sb.device_index)
    n_reads = 1 << 22
    lengths = jnp.full((n_reads,), bench.READ_LEN, jnp.int32)
    for seed, frac in ((2, 0.02), (3, 1.0)):
        codes = bench.sample_read_codes_device(
            genome, n_reads, bench.READ_LEN, seed=seed, random_fraction=frac
        )
        got = eng.search(codes, lengths)
        want = streaming_search_jit(sb.device_index, codes, lengths)
        assert bool(jnp.array_equal(got, want)), f"turbo != LF at random fraction {frac}"


def test_build_on_device_matches_host_build(gpu_device):
    from sbwt_tpu.models.sbwt import SBWT

    bench = _root_module("bench")
    genome = bench.make_corpus_codes()
    host = SBWT.build([genome], bench.K)
    dev = SBWT.build_on_device([genome], bench.K)
    assert dev.number_of_subsets() == host.number_of_subsets()
    assert dev.number_of_kmers() == host.number_of_kmers()
    np.testing.assert_array_equal(dev.C, host.C)
    np.testing.assert_array_equal(dev.bits, host.bits)
    np.testing.assert_array_equal(dev.suffix_group_starts, host.suffix_group_starts)


def test_four_card_dp_tp_match_one_card(four_gpus):
    """DP-turbo over four cards and TP-turbo with the table built sharded
    (2x2, 1x4) must answer exactly like one card."""
    chip_smoke = _root_module("chip_smoke")
    sizes = chip_smoke.Sizes(genome_bp=1_000_000, core_bp=700_000, accessory_blocks=30)
    genomes = chip_smoke.make_genomes(5, sizes)
    reads = chip_smoke.sample_reads(
        genomes, 1 << 16, sizes.read_len, sizes.sub_rate, sizes.random_fraction, seed=6
    )
    report = chip_smoke.Report("", four_gpus[0], out=io.StringIO())
    chip_smoke.four_card_check(genomes, reads, four_gpus, report, sizes.k, sizes.precalc_k)
