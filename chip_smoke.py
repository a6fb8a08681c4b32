"""Bring-up check: the SBWT build -> search path end to end on one GPU.

Drives the main path once, in this process, through the entry points a
user calls (`sbwt_tpu.cli.main` for build / search / build-variant, and
the `SBWT` library for what the CLI does not expose), at the shape of the
reference's own quickstart (BASELINE.json configs[0]: `coli3.fna`, three
E. coli genomes, k = 30, queries of 100 bp reads).  That file is not in
the repository, so three bacterial-size genomes are generated from
`--seed` instead; every size chosen is printed and marked as assumed.

Checks, each fatal (the script exits non-zero; no failure is turned into
exit 0):

* the search output of `--engine auto` (turbo) is byte-identical to
  `--engine lf`, to the rrr-matrix variant under `--engine auto`, and,
  on a read subsample, to the rrr-matrix variant under `--engine lf`;
* the hit/miss of every query equals a numpy set-membership reference
  over the genomes' own k-mers (np.unique + np.searchsorted);
* on a small index (small k), searching all 4^k k-mers on the GPU equals
  the slow independent oracle of tests/oracle.py;
* on a read subsample, the LF engine on JAX's CPU backend, in this same
  process, gives the same ranks as the GPU's search output;
* `SBWT.build_on_device` gives the same bit matrix as the host build.

Every comparison is exact.  Answers are integers (colex ranks, or -1);
the path has no floating-point arithmetic and no matrix product, so TF32
and summation order do not arise and no tolerance is used.

Usage:
    python chip_smoke.py [--seed N]            # one GPU
    python chip_smoke.py --four-cards [--seed N]

`--four-cards` runs only the multi-device path users are offered: the
single-card answers for a read set, DP-turbo over four cards, and
TP-turbo with the table built sharded on 2x2 and 1x4 meshes, all
byte-identical.

The script fails without a GPU (there is no CPU fallback).  Earlier lines
give each phase's time beside the card's name and power limit, the peak
device memory, and the output hashes; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
All files go to a temporary directory that is deleted at the end.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every size the run uses.  The defaults are the full-size run;
    tests pass tiny ones."""

    k: int = 30
    precalc_k: int = 12  # >= log4(n) at ~10M columns, as in the bench
    read_len: int = 100
    # [assumed] genome collection in the shape of coli3.fna: three 5 Mbp
    # genomes sharing a 3.5 Mbp core at 0.5 / 1 / 2 % divergence, each
    # with 1.5 Mbp of its own accessory sequence in 150 blocks
    n_genomes: int = 3
    genome_bp: int = 5_000_000
    core_bp: int = 3_500_000
    divergence: tuple = (0.005, 0.01, 0.02)
    accessory_blocks: int = 150
    # [assumed] reads: two of the CLI's largest device batches (2 x 2^20
    # reads, io/query_runner.py), 0.5 % scattered substitutions, 5 %
    # reads from no genome
    n_reads: int = 2 << 20
    sub_rate: float = 0.005
    random_fraction: float = 0.05
    subsample_reads: int = 1 << 16
    oracle_k: int = 6
    four_card_reads: int = 1 << 20


FULL = Sizes()

_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def peak_bytes(device) -> int | None:
    stats = device.memory_stats()
    return int(stats["peak_bytes_in_use"]) if stats and "peak_bytes_in_use" in stats else None


class Report:
    """Prints one line per phase: wall time, card, peak device memory."""

    def __init__(self, card: str, device, out=sys.stdout):
        self.card = card.splitlines()[0] if card else "no card"
        self.device = device
        self.out = out

    def line(self, msg: str):
        print(msg, file=self.out, flush=True)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        peak = peak_bytes(self.device)
        peak_s = "n/a" if peak is None else f"{peak / 2**30:.2f} GiB"
        self.line(f"phase {name}: {dt:.2f} s [{self.card}] peak device memory so far {peak_s}")


@contextlib.contextmanager
def tee_stderr():
    """Copy everything written to sys.stderr into a buffer as well (the
    CLI reports the engine it chose through its log)."""
    buf = io.StringIO()
    real = sys.stderr

    class _Tee:
        def write(self, s):
            buf.write(s)
            return real.write(s)

        def flush(self):
            real.flush()

    sys.stderr = _Tee()
    try:
        yield buf
    finally:
        sys.stderr = real


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# data, generated from the seed
# ---------------------------------------------------------------------------


def make_genomes(seed: int, sizes: Sizes = FULL) -> list[np.ndarray]:
    """Bacterial-collection-like genomes as int8 code arrays: a shared core
    with per-genome substitutions, cut at random points with blocks of
    accessory sequence of the genome's own inserted between the pieces."""
    n_genomes, genome_bp, core_bp = sizes.n_genomes, sizes.genome_bp, sizes.core_bp
    divergence, n_blocks = sizes.divergence, sizes.accessory_blocks
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 4, size=core_bp, dtype=np.int8)
    acc_bp = genome_bp - core_bp
    genomes = []
    for i in range(n_genomes):
        g = core.copy()
        n_mut = int(core_bp * divergence[i % len(divergence)])
        pos = rng.choice(core_bp, size=n_mut, replace=False)
        g[pos] = (g[pos] + rng.integers(1, 4, size=n_mut)) % 4
        acc = rng.integers(0, 4, size=acc_bp, dtype=np.int8)
        cuts = np.sort(rng.choice(np.arange(1, core_bp), size=n_blocks, replace=False))
        pieces = np.split(g, cuts)
        acc_pieces = np.array_split(acc, n_blocks)
        parts = [pieces[0]]
        for a, p in zip(acc_pieces, pieces[1:]):
            parts += [a, p]
        genomes.append(np.concatenate(parts).astype(np.int8))
    return genomes


def write_fasta(path: str, genomes: list[np.ndarray], width: int = 80) -> None:
    with open(path, "wb") as f:
        for i, g in enumerate(genomes):
            f.write(b">genome_%d\n" % i)
            s = _LUT[g]
            n_full = len(s) // width
            body = np.empty((n_full, width + 1), dtype=np.uint8)
            body[:, :width] = s[: n_full * width].reshape(n_full, width)
            body[:, width] = ord("\n")
            f.write(body.tobytes())
            if len(s) % width:
                f.write(s[n_full * width :].tobytes() + b"\n")


def sample_reads(
    genomes: list[np.ndarray],
    n_reads: int,
    read_len: int,
    sub_rate: float,
    random_fraction: float,
    seed: int = 0,
) -> np.ndarray:
    """[n_reads, read_len] int8 reads: windows of the genomes (genome
    chosen by length) with scattered single-base substitutions, and a
    share of reads of random sequence."""
    rng = np.random.default_rng(seed)
    lens = np.array([len(g) for g in genomes], dtype=np.int64)
    which = rng.choice(len(genomes), size=n_reads, p=lens / lens.sum())
    codes = np.empty((n_reads, read_len), dtype=np.int8)
    for gi, g in enumerate(genomes):
        rows = np.flatnonzero(which == gi)
        starts = rng.integers(0, len(g) - read_len + 1, size=len(rows))
        codes[rows] = g[starts[:, None] + np.arange(read_len)]
    flat = codes.reshape(-1)
    n_sub = int(rng.binomial(flat.size, sub_rate))
    at = rng.integers(0, flat.size, size=n_sub)
    flat[at] = (flat[at] + rng.integers(1, 4, size=n_sub)) % 4
    n_rand = int(n_reads * random_fraction)
    rand_rows = rng.choice(n_reads, size=n_rand, replace=False)
    codes[rand_rows] = rng.integers(0, 4, size=(n_rand, read_len), dtype=np.int8)
    return codes


def write_fastq(path: str, codes: np.ndarray, chunk: int = 1 << 18) -> None:
    """FASTQ records '@r<8 digits>', the read, '+', constant qualities."""
    n, L = codes.shape
    rec = 11 + (L + 1) + 2 + (L + 1)
    with open(path, "wb") as f:
        for s in range(0, n, chunk):
            c = codes[s : s + chunk]
            m = len(c)
            buf = np.empty((m, rec), dtype=np.uint8)
            idx = np.arange(s, s + m, dtype=np.int64)
            buf[:, 0] = ord("@")
            buf[:, 1] = ord("r")
            for d in range(8):
                buf[:, 2 + d] = ord("0") + (idx // 10 ** (7 - d)) % 10
            buf[:, 10] = ord("\n")
            buf[:, 11 : 11 + L] = _LUT[c]
            o = 11 + L
            buf[:, o] = ord("\n")
            buf[:, o + 1] = ord("+")
            buf[:, o + 2] = ord("\n")
            buf[:, o + 3 : o + 3 + L] = ord("I")
            buf[:, o + 3 + L] = ord("\n")
            f.write(buf.tobytes())


# ---------------------------------------------------------------------------
# references that share no code with the engines
# ---------------------------------------------------------------------------


def _pack_windows(codes_2d: np.ndarray, k: int) -> np.ndarray:
    """uint64 [rows, cols-k+1] packed k-mers (2 bits/char, first char
    most significant) of an int8 code matrix; k <= 32."""
    c = codes_2d.astype(np.uint64)
    P = c.shape[1] - k + 1
    v = np.zeros((c.shape[0], P), dtype=np.uint64)
    two = np.uint64(2)
    for j in range(k):
        v <<= two
        v |= c[:, j : j + P]
    return v


def corpus_kmer_set(genomes: list[np.ndarray], k: int) -> np.ndarray:
    """Sorted distinct packed k-mers of the genomes."""
    return np.unique(np.concatenate([_pack_windows(g[None, :], k)[0] for g in genomes]))


def membership_reference(kmer_set: np.ndarray, reads: np.ndarray, k: int, chunk: int = 1 << 17) -> np.ndarray:
    """bool [n_reads, L-k+1]: is each read k-mer in the sorted set."""
    def one(s):
        q = _pack_windows(reads[s : s + chunk], k)
        i = np.searchsorted(kmer_set, q)
        return kmer_set[np.minimum(i, len(kmer_set) - 1)] == q

    with ThreadPoolExecutor(max_workers=max(1, min(8, os.cpu_count() or 1))) as ex:
        parts = list(ex.map(one, range(0, len(reads), chunk)))
    return np.concatenate(parts)


def hits_from_output(path: str, n_reads: int, per_read: int) -> np.ndarray:
    """bool [n_reads, per_read] hit mask parsed from `search` output: a
    token is a miss iff it is '-1'.  Checks every line has per_read
    tokens."""
    buf = np.fromfile(path, dtype=np.uint8)
    sep = (buf == ord(" ")) | (buf == ord("\n"))
    start = ~sep
    start[1:] &= sep[:-1]
    starts = np.flatnonzero(start)
    newlines = np.flatnonzero(buf == ord("\n"))
    if len(newlines) != n_reads:
        raise AssertionError(f"{path}: {len(newlines)} lines, expected {n_reads}")
    per_line = np.diff(np.concatenate([[0], np.searchsorted(starts, newlines)]))
    if not np.all(per_line == per_read):
        raise AssertionError(f"{path}: a line does not hold {per_read} answers")
    return (buf[starts] != ord("-")).reshape(n_reads, per_read)


def ranks_from_output(path: str, n_lines: int) -> np.ndarray:
    """int64 [n_lines, answers] of the first n_lines lines."""
    with open(path, "rb") as f:
        lines = [f.readline() for _ in range(n_lines)]
    rows = [np.array(ln.split(), dtype=np.int64) for ln in lines]
    return np.stack(rows)


def head_bytes(path: str, n_lines: int) -> bytes:
    with open(path, "rb") as f:
        return b"".join(f.readline() for _ in range(n_lines))


def load_oracle_module():
    spec = importlib.util.spec_from_file_location(
        "sbwt_oracle", os.path.join(ROOT, "tests", "oracle.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def cli(args: list[str]) -> str:
    """Run one `sbwt-tpu` command in this process; returns its log.
    A non-zero exit code is fatal."""
    from sbwt_tpu.cli import main as cli_main

    with tee_stderr() as log:
        rc = cli_main(args)
    if rc != 0:
        raise RuntimeError(f"sbwt-tpu {' '.join(args)} exited {rc}")
    return log.getvalue()


def cli_turbo_arity(log: str) -> int | None:
    """The turbo arity a `search` run reports in its log, or None."""
    tag = "Turbo successor engine enabled (arity "
    for ln in log.splitlines():
        if tag in ln:
            return int(ln.split(tag)[1].split(")")[0])
    return None


def library_turbo_choice(index_path: str):
    """Load the index, enable turbo as `--engine auto` does; returns
    (arity, table bytes, free bytes measured before)."""
    from sbwt_tpu.io.serialize import load
    from sbwt_tpu.utils.memory import device_free_bytes

    sb = load(index_path)
    free = device_free_bytes()
    arity = sb.enable_turbo()
    if arity is None:
        return None, 0, free
    t = sb._turbo
    nbytes = int(t.tbl.nbytes) + (int(t.seed_bits.nbytes) if t.seed_bits is not None else 0)
    return arity, nbytes, free


def oracle_check(seed: int, k: int, n_seqs: int = 3, seq_len: int = 400) -> int:
    """All 4^k k-mers searched on the default device, and streaming
    search with turbo, against tests/oracle.py.  Returns #k-mers checked."""
    from sbwt_tpu.models.sbwt import SBWT
    from sbwt_tpu.utils.dna import encode_query

    oracle_mod = load_oracle_module()
    rng = np.random.default_rng(seed + 17)
    base = "".join(rng.choice(list("ACGT"), size=seq_len))
    seqs = [base]
    for _ in range(n_seqs - 1):
        s = list(base)
        for p in rng.choice(seq_len, size=seq_len // 20, replace=False):
            s[p] = "ACGT"[("ACGT".index(s[p]) + int(rng.integers(1, 4))) % 4]
        seqs.append("".join(s))
    oracle = oracle_mod.OracleIndex(seqs, k)
    sb = SBWT.build(seqs, k, precalc_k=min(3, k))
    ids = np.arange(4**k, dtype=np.int64)
    codes = np.stack([(ids >> (2 * (k - 1 - j))) & 3 for j in range(k)], axis=1).astype(np.int8)
    got = sb.search_batch(codes)
    kmers = ["".join("ACGT"[c] for c in row) for row in codes]
    want = np.array([oracle.search(s) for s in kmers], dtype=np.int64)
    if not np.array_equal(np.asarray(got, dtype=np.int64), want):
        raise AssertionError("search of all 4^k k-mers differs from the oracle")
    if sb.enable_turbo(arity=3) != 3:
        raise AssertionError("turbo arity 3 not enabled on the oracle index")
    L = max(len(s) for s in seqs)
    batch = np.full((len(seqs), L), -1, dtype=np.int8)
    for i, s in enumerate(seqs):
        batch[i, : len(s)] = encode_query(s)
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    ans = sb.streaming_search_batch(batch, lengths)
    for i, s in enumerate(seqs):
        want_row = oracle.streaming_search(s)
        if list(np.asarray(ans[i, : len(want_row)])) != want_row:
            raise AssertionError("turbo streaming search differs from the oracle")
    return len(kmers)


def cpu_backend_check(index_path: str, reads: np.ndarray, want_ranks: np.ndarray) -> None:
    """LF streaming search of `reads` on JAX's CPU backend must equal the
    ranks the GPU run wrote."""
    import jax
    import jax.numpy as jnp

    from sbwt_tpu.io.serialize import load
    from sbwt_tpu.ops.search import streaming_search_jit

    cpu = jax.devices("cpu")[0]
    sb = load(index_path)
    index_cpu = jax.device_put(sb.device_index, cpu)
    codes = jax.device_put(jnp.asarray(reads), cpu)
    lengths = jax.device_put(jnp.full((reads.shape[0],), reads.shape[1], jnp.int32), cpu)
    got = np.asarray(streaming_search_jit(index_cpu, codes, lengths)).astype(np.int64)
    if not np.array_equal(got, want_ranks):
        raise AssertionError("CPU-backend LF answers differ from the GPU search output")


def device_build_check(genomes: list[np.ndarray], index_path: str, k: int) -> int:
    """SBWT.build_on_device must give the host build's bit matrix and
    suffix-group marks.  Returns the column count."""
    from sbwt_tpu.io.serialize import load
    from sbwt_tpu.models.sbwt import SBWT

    host = load(index_path)
    dev = SBWT.build_on_device(genomes, k)
    if dev.number_of_subsets() != host.number_of_subsets():
        raise AssertionError(
            f"device build has {dev.number_of_subsets()} columns, host {host.number_of_subsets()}"
        )
    if dev.number_of_kmers() != host.number_of_kmers():
        raise AssertionError("device build k-mer count differs from the host build")
    if not np.array_equal(dev.bits, host.bits):
        raise AssertionError("device build bit matrix differs from the host build")
    if not np.array_equal(dev.suffix_group_starts, host.suffix_group_starts):
        raise AssertionError("device build suffix-group marks differ from the host build")
    if not np.array_equal(dev.C, host.C):
        raise AssertionError("device build C array differs from the host build")
    return host.number_of_subsets()


def four_card_check(genomes, reads: np.ndarray, devices, report: Report, k: int, precalc_k: int) -> None:
    """Single-card turbo answers vs DP-turbo over all four devices and
    TP-turbo with the table built sharded (2x2 and 1x4 meshes)."""
    import jax

    from sbwt_tpu.models.sbwt import SBWT
    from sbwt_tpu.ops.turbo import build_turbo
    from sbwt_tpu.parallel import sharded

    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devices)}")
    devices = list(devices[:4])
    lengths = np.full(reads.shape[0], reads.shape[1], dtype=np.int32)
    with report.phase("four-cards host build"):
        sb = SBWT.build(genomes, k, precalc_k=precalc_k)
    report.line(f"four-cards index: {sb.number_of_subsets()} columns")
    with report.phase("single-card turbo answers"):
        sb.enable_turbo(arity=3)
        ref = sb.streaming_search_batch(reads, lengths)
    report.line(f"single-card answers sha256 {hashlib.sha256(ref.tobytes()).hexdigest()}")
    sb._turbo = None
    sb._turbo_engine = None
    with report.phase("dp-turbo 4x1"):
        mesh = sharded.make_mesh(n_data=4, n_model=1, devices=devices)
        turbo = build_turbo(sb.device_index, arity=3)
        out = np.asarray(jax.block_until_ready(
            sharded.dp_turbo_streaming_search(turbo, sb.device_index, reads, lengths, mesh)
        ))
        del turbo
    if not np.array_equal(out, ref):
        raise AssertionError("DP-turbo answers differ from the single card")
    report.line(f"dp-turbo 4x1 answers identical, sha256 {hashlib.sha256(out.tobytes()).hexdigest()}")
    for n_data, n_model in ((2, 2), (1, 4)):
        name = f"tp-turbo sharded build {n_data}x{n_model}"
        with report.phase(name):
            mesh = sharded.make_mesh(n_data=n_data, n_model=n_model, devices=devices)
            tsh = sharded.build_turbo_sharded(sb.device_index, mesh, arity=3)
            out = np.asarray(jax.block_until_ready(
                sharded.tp_turbo_streaming_search(tsh, sb.device_index, reads, lengths, mesh)
            ))
            del tsh
        if not np.array_equal(out, ref):
            raise AssertionError(f"{name} answers differ from the single card")
        report.line(f"{name} answers identical, sha256 {hashlib.sha256(out.tobytes()).hexdigest()}")


def single_card(seed: int, report: Report, tmp: str, sizes: Sizes = FULL) -> None:
    """The single-card path: build, search with every engine, compare."""
    from sbwt_tpu import native

    z = sizes
    k, n_reads, n_sub = z.k, z.n_reads, z.subsample_reads

    report.line(
        f"native reader/formatter in use: {native.available()} "
        "(False means the pure-Python fallback serves the CLI)"
    )
    P = z.read_len - k + 1

    with report.phase("generate genomes"):
        genomes = make_genomes(seed, z)
        fasta = os.path.join(tmp, "genomes.fna")
        write_fasta(fasta, genomes)
    report.line(
        f"[assumed] {z.n_genomes} genomes of {z.genome_bp} bp (core {z.core_bp} bp at "
        f"divergence {z.divergence}, {z.genome_bp - z.core_bp} bp accessory in "
        f"{z.accessory_blocks} blocks); FASTA {os.path.getsize(fasta)} bytes"
    )
    with report.phase("generate reads"):
        reads = sample_reads(
            genomes, n_reads, z.read_len, z.sub_rate, z.random_fraction, seed=seed + 1
        )
        fastq = os.path.join(tmp, "reads.fastq")
        write_fastq(fastq, reads)
        sub_fastq = os.path.join(tmp, "reads_sub.fastq")
        write_fastq(sub_fastq, reads[:n_sub])
    report.line(
        f"[assumed] {n_reads} reads of {z.read_len} bp, substitution rate {z.sub_rate}, "
        f"random-read fraction {z.random_fraction}; {n_reads * P} queries; "
        f"FASTQ {os.path.getsize(fastq)} bytes"
    )

    plain = os.path.join(tmp, "plain.sbwt")
    with report.phase("cli build"):
        cli(["build", "-i", fasta, "-o", plain, "-k", str(k), "-p", str(z.precalc_k), "-d", tmp])
    report.line(f"index {os.path.getsize(plain)} bytes")

    with report.phase("library turbo check"):
        arity, tbl_bytes, free = library_turbo_choice(plain)
    report.line(f"enable_turbo(): arity {arity}, table {tbl_bytes} bytes, free device memory {free} bytes")
    if arity is None:
        raise AssertionError("turbo was not enabled at this index size")

    out_auto = os.path.join(tmp, "auto.txt")
    with report.phase("cli search auto (cold, compile included)"):
        log = cli(["search", "-i", plain, "-q", fastq, "-o", out_auto, "--engine", "auto"])
    if cli_turbo_arity(log) != arity:
        raise AssertionError(f"search --engine auto ran arity {cli_turbo_arity(log)}, expected {arity}")
    h_auto = file_sha256(out_auto)
    report.line(f"auto output sha256 {h_auto} ({os.path.getsize(out_auto)} bytes)")
    with report.phase("cli search auto (warm)"):
        cli(["search", "-i", plain, "-q", fastq, "-o", out_auto, "--engine", "auto"])
    if file_sha256(out_auto) != h_auto:
        raise AssertionError("warm auto output differs from the cold run")

    with report.phase("numpy membership reference"):
        want_hits = membership_reference(corpus_kmer_set(genomes, k), reads, k)
        got_hits = hits_from_output(out_auto, n_reads, P)
    if not np.array_equal(got_hits, want_hits):
        bad = int(np.sum(got_hits != want_hits))
        raise AssertionError(f"hit/miss differs from the numpy reference at {bad} queries")
    report.line(f"hit/miss equal to the numpy reference on all {want_hits.size} queries "
                f"(hit fraction {want_hits.mean():.4f})")
    want_sub = ranks_from_output(out_auto, n_sub)
    auto_head = head_bytes(out_auto, n_sub)

    out_lf = os.path.join(tmp, "lf.txt")
    with report.phase("cli search lf"):
        cli(["search", "-i", plain, "-q", fastq, "-o", out_lf, "--engine", "lf"])
    h_lf = file_sha256(out_lf)
    report.line(f"lf output sha256 {h_lf}")
    if h_lf != h_auto:
        raise AssertionError("lf output differs from auto")
    os.remove(out_lf)

    rrr = os.path.join(tmp, "rrr.sbwt")
    with report.phase("cli build-variant rrr-matrix"):
        cli(["build-variant", "-i", plain, "-o", rrr, "--variant", "rrr-matrix"])
    out_rrr = os.path.join(tmp, "rrr_auto.txt")
    with report.phase("cli search rrr auto"):
        log = cli(["search", "-i", rrr, "-q", fastq, "-o", out_rrr, "--engine", "auto"])
    h_rrr = file_sha256(out_rrr)
    report.line(f"rrr auto output sha256 {h_rrr} (turbo arity {cli_turbo_arity(log)})")
    if h_rrr != h_auto:
        raise AssertionError("rrr auto output differs from plain auto")
    os.remove(out_rrr)
    out_rrr_lf = os.path.join(tmp, "rrr_lf.txt")
    with report.phase(f"cli search rrr lf ({n_sub} reads)"):
        cli(["search", "-i", rrr, "-q", sub_fastq, "-o", out_rrr_lf, "--engine", "lf"])
    with open(out_rrr_lf, "rb") as f:
        rrr_lf = f.read()
    report.line(f"rrr lf subsample output sha256 {hashlib.sha256(rrr_lf).hexdigest()}, "
                f"auto prefix sha256 {hashlib.sha256(auto_head).hexdigest()}")
    if rrr_lf != auto_head:
        raise AssertionError("rrr lf subsample output differs from the auto output")

    with report.phase(f"cpu-backend lf ({n_sub} reads)"):
        cpu_backend_check(plain, reads[:n_sub], want_sub)
    report.line("cpu-backend LF answers equal the GPU output")

    with report.phase("build_on_device"):
        n_cols = device_build_check(genomes, plain, k)
    report.line(f"build_on_device bit matrix equal to the host build ({n_cols} columns)")

    with report.phase(f"oracle (k={z.oracle_k}, all 4^k k-mers)"):
        n_k = oracle_check(seed, z.oracle_k)
    report.line(f"oracle agrees on all {n_k} k-mers and on turbo streaming search")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card DP/TP path and its comparison")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    d0 = devices[0]
    if d0.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found platform {d0.platform!r} "
              f"({d0.device_kind})", file=sys.stderr)
        return 2
    from bench import card_name_and_power_limit

    card = card_name_and_power_limit()
    print(f"device: platform {d0.platform}, kind {d0.device_kind}, count {len(devices)}", flush=True)
    print(f"nvidia-smi name, power.limit: {card}", flush=True)

    from sbwt_tpu.utils.compile_cache import configure_compile_cache

    print(f"compile cache: {configure_compile_cache()}", flush=True)
    report = Report(card, d0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four_cards:
            genomes = make_genomes(args.seed, FULL)
            reads = sample_reads(
                genomes, FULL.four_card_reads, FULL.read_len, FULL.sub_rate,
                FULL.random_fraction, seed=args.seed + 1,
            )
            four_card_check(genomes, reads, devices, report, FULL.k, FULL.precalc_k)
        else:
            single_card(args.seed, report, tmp, FULL)
    report.line(f"total {time.perf_counter() - t0:.2f} s [{report.card}]")
    print(json.dumps({
        "ok": True,
        "device": {"platform": d0.platform, "kind": d0.device_kind, "count": len(devices)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
