"""Benchmark: streaming k-mer membership queries/second on one GPU.

Workload mirrors the reference's headline path (`sbwt search` on a k=30
plain-matrix index, src/CLI/sbwt_search.cpp:46-65): build an index over a
genome, stream 100bp reads sampled from it (mostly-positive queries, like
example_data/queries.fastq against its source genome), measure k-mer
answers per second on device, excluding I/O.

    python bench.py                       # the headline cell
    SBWT_BENCH_MODE=full python bench.py  # + every regime cell and the
                                          #   build benchmark, written to
                                          #   BENCH_REGIMES.json

The launcher (this process) never imports JAX.  Every cell, the headline
included, runs in its own child process, one after another, so exactly
one process holds the card at a time; the `widet1` cells need a process
of their own anyway because x64 is process-global.  A cell refuses to run
on any platform but `gpu`.

Prints the card (nvidia-smi name and power limit), then as its last line
one JSON object: {"metric", "value", "unit", "device", "card"}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

K = 30
READ_LEN = 100
HEADLINE = "turbo3_hit98"
FULL_CELLS = [
    "turbo3_hit98_auto", "turbo3_hit50_auto", "turbo3_hit0_auto",
    "turbo3_hit50", "turbo3_hit0",
    "turbo2_hit98",
    "turbo1_hit98", "turbo1_hit50", "turbo1_hit0",
    "lf_hit98", "lf_hit50", "lf_hit0",
    "rrr_turbo3_hit98",
    "rrr_lf_hit98", "mef_lf_hit98", "split_lf_hit98",
    "concat_lf_hit98", "subsetwt_lf_hit98",
    "repeat_turbo3_hit98", "repeat_turbo3_hit0", "repeat_turbo1_hit98",
    "widet1_hit98", "widet1_hit0",
]
_ROOT = os.path.dirname(os.path.abspath(__file__))


def make_corpus_codes(genome_mbp: float = 4.0, seed: int = 20260817) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(genome_mbp * 1e6)
    return rng.integers(0, 4, size=n, dtype=np.int8)


def sample_read_codes_device(
    genome_codes: np.ndarray,
    n_reads: int,
    read_len: int,
    seed: int = 1,
    random_fraction: float = 0.02,
):
    """Device-side read sampling: upload the genome once and gather the
    [n_reads, read_len] batch on the device instead of uploading a
    multi-hundred-MB host batch."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def mk(genome, key):
        k1, k2, k3 = jax.random.split(key, 3)
        starts = jax.random.randint(
            k1, (n_reads,), 0, len(genome_codes) - read_len, dtype=jnp.int32
        )
        codes = genome[starts[:, None] + jnp.arange(read_len, dtype=jnp.int32)[None, :]]
        n_rand = max(1, int(n_reads * random_fraction))
        # rows chosen WITHOUT replacement (a random permutation prefix):
        # sampling with replacement under-delivers the requested fraction
        # badly at high fractions (1 - e^-1 = 63% distinct rows at
        # fraction 1.0), which would make the miss-heavy regimes
        # friendlier than their labels claim
        rand_rows = jax.random.permutation(k2, n_reads)[:n_rand]
        rand_codes = jax.random.randint(
            k3, (n_rand, read_len), 0, 4, dtype=jnp.int8
        )
        return codes.at[rand_rows].set(rand_codes)

    return mk(jnp.asarray(genome_codes), jax.random.PRNGKey(seed))


def make_repeat_corpus(
    n_copies: int = 8, base_mbp: float = 0.5, seed: int = 20260821
):
    """Pangenome-like corpus: n_copies mutated copies of one base genome
    (0.1%..1% per-copy divergence, like strains of one species).  Unlike
    the uniform-random corpus, repeated sequence makes many precalc seeds
    NON-singleton, which is exactly the turbo fast path's unfriendly case.

    Returns (copies list for the builder, concatenation for sampling)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=int(base_mbp * 1e6), dtype=np.int8)
    copies = []
    for i in range(n_copies):
        c = base.copy()
        rate = 0.001 + 0.009 * i / max(1, n_copies - 1)
        n_mut = int(len(base) * rate)
        posn = rng.choice(len(base), size=n_mut, replace=False)
        c[posn] = (c[posn] + rng.integers(1, 4, size=n_mut)) % 4
        copies.append(c)
    return copies, np.concatenate(copies)


def _git_commit() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10, cwd=_ROOT,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def card_name_and_power_limit() -> str:
    """`name, power.limit` of every card, from nvidia-smi (a subprocess
    that stays off JAX).  Raises when the tool is missing or fails: no
    card, no measurement."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    return out


# ---------------------------------------------------------------------------
# one cell (child process)
# ---------------------------------------------------------------------------

_VARIANT_ENGINES = {
    "rrr": "rrr-matrix",
    "mef": "mef-matrix",
    "split": "plain-split",
    "concat": "plain-concat",
    "subsetwt": "plain-subsetwt",
}


def run_cell(regime: str) -> dict:
    """Measure one cell on the GPU and return its record.

    Grammar: [repeat_]<engine>_<hitX>[_auto] with engine in
    turbo3|turbo2|turbo1|widet1|lf|rrr_lf|mef_lf|split_lf|concat_lf|
    subsetwt_lf|rrr_turbo3.  <name>_auto cells measure the hint-free
    production dispatch path (AdaptiveTurboEngine — what `sbwt-tpu
    search` actually runs) on the same workload as the hinted cell."""
    import jax

    from sbwt_tpu.utils.compile_cache import configure_compile_cache

    devices = jax.devices()
    d0 = devices[0]
    if d0.platform != "gpu":
        raise SystemExit(
            f"bench: needs a GPU, found platform {d0.platform!r} ({d0.device_kind})"
        )
    device = {"platform": d0.platform, "kind": d0.device_kind, "count": len(devices)}
    print(f"bench: device {json.dumps(device)}", file=sys.stderr, flush=True)
    configure_compile_cache()

    import jax.numpy as jnp

    from sbwt_tpu.models.sbwt import SBWT
    from sbwt_tpu.ops.search import streaming_search
    from sbwt_tpu.ops.turbo import build_turbo, turbo_streaming_search
    from sbwt_tpu.utils.logging import write_log

    k, read_len = K, READ_LEN
    n_reads = int(os.environ.get("SBWT_BENCH_READS", 1 << 22))
    auto_mode = regime.endswith("_auto")
    regime_m = regime[: -len("_auto")] if auto_mode else regime
    repeat = regime_m.startswith("repeat_")
    base_regime = regime_m[len("repeat_"):] if repeat else regime_m
    if base_regime.startswith("widet1"):
        jax.config.update("jax_enable_x64", True)
    if repeat:
        build_seqs, genome_codes = make_repeat_corpus()
        write_log("bench: repeat-heavy corpus (8 mutated copies of 0.5 Mbp)")
    else:
        genome_codes = make_corpus_codes()
        build_seqs = [genome_codes]
    write_log(f"bench: building k={k} index over {len(genome_codes)/1e6:.1f} Mbp")
    t0 = time.perf_counter()
    # p=13 >> log4(n): most random seeds are empty and only a small share
    # of positions hit a non-singleton seed, so the turbo fast path covers
    # essentially all restarts
    sbwt = SBWT.build(build_seqs, k, precalc_k=13)
    build_s = time.perf_counter() - t0
    write_log(
        f"bench: built {sbwt.number_of_kmers()} kmers / {sbwt.number_of_subsets()} subsets "
        f"in {build_s:.1f}s"
    )
    turbo = None
    if base_regime.startswith("turbo"):
        arity = int(base_regime[5])
        t0 = time.perf_counter()
        turbo = build_turbo(sbwt.device_index, arity=arity)
        jax.block_until_ready(turbo.tbl)
        write_log(f"bench: turbo table (arity {arity}) built in {time.perf_counter() - t0:.1f}s")

    lengths_d = jnp.asarray(np.full(n_reads, read_len, dtype=np.int32))
    # static regime hints remove the engine's data-dependent dispatch; the
    # regime runner knows its hit rate (auto cells discover their own)
    hint = None
    if not auto_mode:
        hint = {"hit98": "hit", "hit50": "mid", "hit0": "miss"}[regime_m.rsplit("_", 1)[1]]
    frac = {"hit98": 0.02, "hit50": 0.5, "hit0": 1.0}[regime_m.rsplit("_", 1)[1]]
    vkey = base_regime.split("_", 1)[0]

    # Timed programs reduce the answer matrix to (checksum, hits) on
    # device: keeping the full [n_reads, n_answers] matrix alive across
    # reps would double the memory footprint.
    @jax.jit
    def run_turbo(t, ix, codes, lengths):
        out = turbo_streaming_search(t, ix, codes, lengths, regime_hint=hint)
        return jnp.sum(out), jnp.sum((out >= 0).astype(jnp.int64))

    if base_regime.startswith("widet1"):
        # wide (int64) engine + its arity-1 pair-row turbo tier, forced
        # onto the bench index (same data, int64 lanes)
        from sbwt_tpu.models.wide import from_packed_rows_wide

        di = sbwt.device_index
        words = np.ascontiguousarray(np.asarray(di.rank_tbl)[:, 0]).view(
            np.uint32
        ).reshape(4, di.n_words)
        sgs_w = (
            np.ascontiguousarray(np.asarray(di.sgs_tbl)[:, 0]).view(np.uint32)
            if di.has_streaming
            else None
        )
        wide_ix = from_packed_rows_wide(
            words, di.n_nodes, sgs_w, k=k, n_kmers=di.n_kmers,
            precalc_k=di.precalc_k, precalc_table=np.asarray(di.precalc),
        )
        wturbo = build_turbo(wide_ix, arity=1)
        jax.block_until_ready(wturbo.tbl)
        n_r = n_reads
        c = sample_read_codes_device(genome_codes, n_r, read_len, seed=2, random_fraction=frac)
        fn = lambda cc: run_turbo(wturbo, wide_ix, cc, lengths_d[:n_r])
    elif base_regime.startswith("turbo"):
        # arity 1's table is 16 B/col, leaving room for 8M lanes;
        # arity 3's 1 KiB/col table keeps the default
        n_r = (
            max(n_reads, 1 << 23)
            if base_regime.startswith("turbo1") and "SBWT_BENCH_READS" not in os.environ
            else n_reads
        )
        c = sample_read_codes_device(genome_codes, n_r, read_len, seed=2, random_fraction=frac)
        lengths_r = jnp.asarray(np.full(n_r, read_len, dtype=np.int32))
        if auto_mode:
            # the production dispatch path, exactly as the CLI runs it:
            # hint-free, seeded by the strided probe on batch 1,
            # steady-state hinted by the previous batch's hit count
            from sbwt_tpu.ops.turbo import AdaptiveTurboEngine

            eng = AdaptiveTurboEngine(turbo, sbwt.device_index)
            fn = lambda cc: eng.search_reduced(cc, lengths_r)
        else:
            fn = lambda cc: run_turbo(turbo, sbwt.device_index, cc, lengths_r)
    elif vkey in _VARIANT_ENGINES and base_regime.split("_")[1].startswith("turbo"):
        # variant + turbo: the successor table is variant-independent
        # once built (ops/turbo.py), so a compressed variant queries on
        # the turbo engine too
        variant = _VARIANT_ENGINES[vkey]
        ar = int(base_regime.split("_")[1][5:] or "3")
        write_log(f"bench: re-encoding {variant} variant")
        var = sbwt.to_variant(variant)
        t0 = time.perf_counter()
        turbo_v = build_turbo(var.device_index, arity=ar)
        jax.block_until_ready(turbo_v.tbl)
        write_log(
            f"bench: turbo table (arity {ar}) from {variant} in "
            f"{time.perf_counter() - t0:.1f}s"
        )
        n_r = n_reads
        c = sample_read_codes_device(genome_codes, n_r, read_len, seed=2, random_fraction=frac)
        fn = lambda cc: run_turbo(turbo_v, var.device_index, cc, lengths_d[:n_r])
    elif vkey in _VARIANT_ENGINES:
        # compressed/structured variants run the generic LF streaming
        # engine over their own rank structures, in 256K-read dispatches
        variant = _VARIANT_ENGINES[vkey]
        n_r = min(n_reads, 1 << 20)
        ch = min(n_r, 1 << 18)
        write_log(f"bench: re-encoding {variant} variant")
        var = sbwt.to_variant(variant)
        c = sample_read_codes_device(genome_codes, n_r, read_len, seed=4, random_fraction=frac)

        @jax.jit
        def run_var(index, codes, lengths):
            out = streaming_search(index, codes, lengths)
            return jnp.sum(out), jnp.sum((out >= 0).astype(jnp.int64))

        def fn(cc):
            s = h = 0
            for i in range(0, n_r, ch):
                c_ch = cc[i : i + ch]
                # lengths sliced to the chunk's ACTUAL size: the final
                # chunk is short when n_r % ch != 0
                s_, h_ = run_var(var.device_index, c_ch, lengths_d[: c_ch.shape[0]])
                s += int(s_)
                h += int(h_)
            return s, h
    else:  # lf
        n_r = min(n_reads, 1 << 21)
        c = sample_read_codes_device(genome_codes, n_r, read_len, seed=3, random_fraction=frac)

        @jax.jit
        def run_lf(index, codes, lengths):
            out = streaming_search(index, codes, lengths)
            return jnp.sum(out), jnp.sum((out >= 0).astype(jnp.int64))

        fn = lambda cc: run_lf(sbwt.device_index, cc, lengths_d[:n_r])

    n_q = n_r * (read_len - k + 1)
    t0 = time.perf_counter()
    _, hits_w = jax.block_until_ready(fn(c))  # compile + warm
    warm_s = time.perf_counter() - t0
    reps = 5
    rep_qps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(c))
        rep_qps.append(n_q / (time.perf_counter() - t0))
    srt = sorted(rep_qps)
    return {
        "regime": regime,
        "qps": srt[len(srt) // 2],  # median of reps
        "qps_min": srt[0], "qps_max": srt[-1],
        "qps_reps": rep_qps,
        "hit_rate": int(hits_w) / n_q,
        "warmup_s": warm_s, "build_s": build_s, "n_reads": n_r, "reps": reps,
        "device": device,
        "commit": _git_commit(), "date": time.strftime("%Y-%m-%d"),
    }


# ---------------------------------------------------------------------------
# launcher (parent process, never imports JAX)
# ---------------------------------------------------------------------------


def _run_child(regime: str) -> dict:
    """Run one cell in a fresh interpreter; its stderr passes through."""
    env = dict(os.environ)
    env["SBWT_BENCH_REGIME"] = regime
    env.pop("SBWT_BENCH_MODE", None)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__)],
        env=env, stdout=subprocess.PIPE, text=True, cwd=_ROOT,
    )
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"bench cell {regime} failed (exit {proc.returncode})")
    return json.loads(lines[-1])


def _run_build_benchmark() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT
    proc = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "benchmarks", "build_benchmark.py"), "--mbp", "16"],
        env=env, stdout=subprocess.PIPE, text=True, cwd=_ROOT,
    )
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return {"error": f"build benchmark failed (exit {proc.returncode})"}
    return json.loads(lines[-1])


def main() -> int:
    regime = os.environ.get("SBWT_BENCH_REGIME")
    if regime:
        print(json.dumps(run_cell(regime)))
        return 0

    card = card_name_and_power_limit()
    print(f"card: {card}", flush=True)
    headline = _run_child(HEADLINE)
    print(f"bench: {json.dumps(headline)}", file=sys.stderr, flush=True)
    if os.environ.get("SBWT_BENCH_MODE") == "full":
        regimes = {HEADLINE: headline}
        for name in FULL_CELLS:
            try:
                regimes[name] = _run_child(name)
            except RuntimeError as e:
                regimes[name] = {"error": str(e)}
            print(f"bench: {name} done", file=sys.stderr, flush=True)
        record = {
            "k": K, "read_len": READ_LEN, "card": card,
            "regimes": regimes, "build": _run_build_benchmark(),
        }
        with open(os.path.join(_ROOT, "BENCH_REGIMES.json"), "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({
        "metric": "streaming_kmer_queries_per_sec_per_gpu",
        "value": headline["qps"],
        "unit": "queries/s",
        "device": headline["device"],
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
