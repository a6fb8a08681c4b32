"""CPU tests of what the GPU bring-up added or changed: the compile-cache
helper, chip_smoke.py's phases at tiny size, the CLI's turbo fallback,
the strict device-memory probe, the bench launcher's refusals and the
native library build."""
import io
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(
    genome_bp=60_000, core_bp=40_000, accessory_blocks=5, n_reads=3000,
    subsample_reads=500, precalc_k=8, oracle_k=4,
)


def _report():
    return chip_smoke.Report("cpu", jax.devices()[0], out=io.StringIO())


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------


@pytest.fixture
def restore_cache_config():
    names = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_entry_size_bytes",
        "jax_persistent_cache_min_compile_time_secs",
    )
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_compile_cache_honours_env_var(monkeypatch, tmp_path, restore_cache_config):
    from sbwt_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == before
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 1


def test_compile_cache_defaults_to_checkout_root(monkeypatch, restore_cache_config):
    from sbwt_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(_ROOT, ".jax_cache")
    assert compile_cache.DEFAULT_DIR == want
    assert compile_cache.configure_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    with open(os.path.join(_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ---------------------------------------------------------------------------
# chip_smoke.py phases at tiny size
# ---------------------------------------------------------------------------


def test_make_genomes_shape_and_shared_core():
    genomes = chip_smoke.make_genomes(3, TINY)
    assert len(genomes) == TINY.n_genomes
    assert all(len(g) == TINY.genome_bp and g.dtype == np.int8 for g in genomes)
    assert all(g.min() >= 0 and g.max() <= 3 for g in genomes)
    sets = [set(chip_smoke._pack_windows(g[None, :], 30)[0].tolist()) for g in genomes]
    shared = len(sets[0] & sets[1])
    # the core is shared but diverged: many common k-mers, not all
    assert 0.2 * len(sets[0]) < shared < 0.9 * len(sets[0])
    # same seed, same genomes
    assert all(np.array_equal(a, b) for a, b in zip(genomes, chip_smoke.make_genomes(3, TINY)))


def test_fasta_and_fastq_round_trip(tmp_path):
    from sbwt_tpu.io.seqio import read_sequences

    genomes = chip_smoke.make_genomes(4, TINY)
    fasta = str(tmp_path / "g.fna")
    chip_smoke.write_fasta(fasta, genomes)
    got = read_sequences(fasta)
    assert [bytes(chip_smoke._LUT[g]) for g in genomes] == [bytes(s) for s in got]
    reads = chip_smoke.sample_reads(genomes, 300, 100, 0.005, 0.05, seed=1)
    fastq = str(tmp_path / "r.fastq")
    chip_smoke.write_fastq(fastq, reads, chunk=128)
    got = read_sequences(fastq)
    assert [bytes(chip_smoke._LUT[r]) for r in reads] == [bytes(s) for s in got]


def test_sample_reads_rates():
    genomes = chip_smoke.make_genomes(5, TINY)
    reads = chip_smoke.sample_reads(genomes, 20_000, 100, 0.01, 0.1, seed=2)
    assert reads.shape == (20_000, 100) and reads.dtype == np.int8
    kset = chip_smoke.corpus_kmer_set(genomes, 30)
    hits = chip_smoke.membership_reference(kset, reads, 30, chunk=4096)
    # a random read has no genome k-mer; a sampled read with no
    # substitution in a window hits there
    no_hit_rows = np.mean(~hits.any(axis=1))
    assert 0.08 < no_hit_rows < 0.14
    assert 0.55 < hits.mean() < 0.85


def test_membership_reference_matches_engine():
    from sbwt_tpu.models.sbwt import SBWT

    genomes = chip_smoke.make_genomes(6, TINY)
    reads = chip_smoke.sample_reads(genomes, 256, 100, 0.01, 0.2, seed=3)
    sb = SBWT.build(genomes, 30, precalc_k=8)
    ans = sb.streaming_search_batch(reads)
    want = chip_smoke.membership_reference(chip_smoke.corpus_kmer_set(genomes, 30), reads, 30, chunk=64)
    np.testing.assert_array_equal(ans >= 0, want)


def test_hits_from_output_parses_and_checks_line_shape(tmp_path):
    p = tmp_path / "out.txt"
    p.write_bytes(b"3 -1 17 \n-1 -1 0 \n")
    np.testing.assert_array_equal(
        chip_smoke.hits_from_output(str(p), 2, 3),
        [[True, False, True], [False, False, True]],
    )
    np.testing.assert_array_equal(chip_smoke.ranks_from_output(str(p), 1), [[3, -1, 17]])
    assert chip_smoke.head_bytes(str(p), 1) == b"3 -1 17 \n"
    p.write_bytes(b"3 -1 \n-1 -1 0 \n")
    with pytest.raises(AssertionError):
        chip_smoke.hits_from_output(str(p), 2, 3)
    with pytest.raises(AssertionError):
        chip_smoke.hits_from_output(str(p), 3, 3)


def test_cli_turbo_arity_from_log():
    log = "x (0.1s): Loaded the index\ny (0.2s): Turbo successor engine enabled (arity 2)\n"
    assert chip_smoke.cli_turbo_arity(log) == 2
    assert chip_smoke.cli_turbo_arity("Turbo engine unavailable (x); using LF engine") is None


def test_oracle_check_tiny():
    assert chip_smoke.oracle_check(1, 4, n_seqs=2, seq_len=120) == 4**4


def test_single_card_path_tiny(tmp_path):
    """The whole single-card run, every comparison included, on the CPU."""
    report = _report()
    chip_smoke.single_card(7, report, str(tmp_path), TINY)
    text = report.out.getvalue()
    for want in (
        "hit/miss equal to the numpy reference",
        "cpu-backend LF answers equal",
        "build_on_device bit matrix equal",
        "oracle agrees",
    ):
        assert want in text


def test_four_card_path_on_virtual_devices():
    devices = jax.devices()
    assert len(devices) >= 4
    genomes = chip_smoke.make_genomes(8, TINY)
    reads = chip_smoke.sample_reads(genomes, 1024, 100, 0.005, 0.05, seed=9)
    report = _report()
    chip_smoke.four_card_check(genomes, reads, devices, report, 30, 8)
    assert report.out.getvalue().count("answers identical") == 3


def test_four_card_path_needs_four_devices():
    with pytest.raises(RuntimeError):
        chip_smoke.four_card_check([], np.zeros((4, 100), np.int8), jax.devices()[:2], _report(), 30, 8)


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# ---------------------------------------------------------------------------
# CLI: only documented ValueErrors fall back to LF
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_index(tmp_path):
    from sbwt_tpu.cli import main as cli_main

    genomes = chip_smoke.make_genomes(10, TINY)
    fasta = str(tmp_path / "g.fna")
    chip_smoke.write_fasta(fasta, genomes)
    reads = chip_smoke.sample_reads(genomes, 200, 100, 0.005, 0.1, seed=11)
    fastq = str(tmp_path / "r.fastq")
    chip_smoke.write_fastq(fastq, reads)
    index = str(tmp_path / "plain.sbwt")
    assert cli_main(["build", "-i", fasta, "-o", index, "-k", "30", "-p", "8", "-d", str(tmp_path)]) == 0
    return index, fastq


def _raise(exc):
    def f(*a, **k):
        raise exc

    return f


def test_search_fails_when_turbo_build_raises_other_errors(tiny_index, tmp_path, monkeypatch):
    from sbwt_tpu.cli import main as cli_main
    from sbwt_tpu.ops import turbo

    index, fastq = tiny_index
    monkeypatch.setattr(turbo, "build_turbo", _raise(RuntimeError("device out of memory")))
    assert cli_main(["search", "-i", index, "-q", fastq, "-o", str(tmp_path / "o.txt")]) == 1


def test_search_falls_back_to_lf_on_value_error(tiny_index, tmp_path, monkeypatch):
    from sbwt_tpu.cli import main as cli_main
    from sbwt_tpu.ops import turbo

    index, fastq = tiny_index
    lf = str(tmp_path / "lf.txt")
    assert cli_main(["search", "-i", index, "-q", fastq, "-o", lf, "--engine", "lf"]) == 0
    monkeypatch.setattr(turbo, "build_turbo", _raise(ValueError("turbo arity must be 1, 2 or 3")))
    auto = str(tmp_path / "auto.txt")
    assert cli_main(["search", "-i", index, "-q", fastq, "-o", auto, "--engine", "auto"]) == 0
    with open(lf, "rb") as a, open(auto, "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# device memory probe and the win2 side-table budget
# ---------------------------------------------------------------------------


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_device_free_bytes_raises_for_unmeasurable_gpu(stats):
    from sbwt_tpu.utils.memory import device_free_bytes

    with pytest.raises(RuntimeError):
        device_free_bytes(_FakeDevice("gpu", stats))


def test_device_free_bytes_reads_the_allocator_pool():
    from sbwt_tpu.utils.memory import device_free_bytes

    dev = _FakeDevice("gpu", {"bytes_limit": 60 << 30, "bytes_in_use": 4 << 30})
    assert device_free_bytes(dev) == 56 << 30
    assert device_free_bytes(_FakeDevice("cpu", None)) > 0


def test_win2_side_table_budget():
    from sbwt_tpu.utils.memory import WIN2_BYTES_PER_POSITION, win2_side_table_fits

    # the bench batch (4M reads x 71 positions) and the CLI batch (1M x
    # 99 at the 128-column pad) fit beside a 4 GB table in a 60 GB pool
    free = (60 << 30) - (4 << 30)
    assert win2_side_table_fits((1 << 22) * 71, free_bytes=free)
    assert win2_side_table_fits((1 << 20) * 99, free_bytes=free)
    assert win2_side_table_fits((1 << 20) * 99, wide=True, free_bytes=free)
    # past half of free memory the packed-words path serves
    n = (free // 2) // WIN2_BYTES_PER_POSITION
    assert win2_side_table_fits(n, free_bytes=free)
    assert not win2_side_table_fits(n + 1, free_bytes=free)
    assert not win2_side_table_fits(n, wide=True, free_bytes=free)


def test_select_turbo_arity_measures_when_not_given(monkeypatch):
    from sbwt_tpu.utils import memory

    monkeypatch.setattr(memory, "device_free_bytes", lambda device=None: 60 << 30)
    assert memory.select_turbo_arity(11_000_000) == 3
    monkeypatch.setattr(memory, "device_free_bytes", lambda device=None: 1 << 30)
    assert memory.select_turbo_arity(11_000_000) == 1


# ---------------------------------------------------------------------------
# bench launcher and native library build
# ---------------------------------------------------------------------------


def test_bench_cell_refuses_cpu():
    env = dict(os.environ, SBWT_BENCH_REGIME="turbo3_hit98", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "bench.py")], env=env, cwd=_ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr
    assert proc.stdout.strip() == ""


def test_bench_launcher_needs_a_card(monkeypatch):
    import bench

    def no_card(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(bench.subprocess, "run", no_card)
    with pytest.raises(FileNotFoundError):
        bench.main()


def test_native_build_is_portable_and_atomic(monkeypatch):
    from sbwt_tpu import native

    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(native.subprocess, "run", fake_run)
    assert native._build() is False
    (cmd,) = seen
    assert not any(a.startswith("-march") for a in cmd)
    out = cmd[cmd.index("-o") + 1]
    assert out != native._SO and out.startswith(native._SO)
    assert not os.path.exists(out)
