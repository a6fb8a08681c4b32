"""Query micro-benchmarks, mirroring the reference's sbwt_query_benchmark
(tests/query_benchmark.cpp:10-104): us/query for

  1. sequential k-mer access (reconstruct-order get_kmer),
  2. select-supported k-mer access (get_kmer_fast),
  3. individual search,
  4. streaming search,
  5. streaming search via the turbo successor-pair engine,

each with checksums to defeat dead-code elimination.  Runs on whatever
backend JAX selects (the GPU by default; CPU with JAX_PLATFORMS=cpu) and
prints that device first.

Usage: python benchmarks/query_benchmark.py [--n 100000] [--genome-mbp 1.0]
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000, help="queries per benchmark")
    ap.add_argument("--genome-mbp", type=float, default=1.0)
    ap.add_argument("--k", type=int, default=30)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from sbwt_tpu.models.sbwt import SBWT
    from sbwt_tpu.ops.search import search_jit, streaming_search_jit
    from sbwt_tpu.ops.turbo import build_turbo, turbo_streaming_jit
    from sbwt_tpu.utils.compile_cache import configure_compile_cache
    from sbwt_tpu.utils.dna import encode_query

    configure_compile_cache()
    d0 = jax.devices()[0]
    print(f"device: {d0.platform} {d0.device_kind} x{len(jax.devices())}", flush=True)
    rng = np.random.default_rng(1234)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                        size=int(args.genome_mbp * 1e6)).tobytes().decode()
    k = args.k
    print(f"building k={k} index over {len(genome)/1e6:.1f} Mbp ...", flush=True)
    sb = SBWT.build([genome], k, precalc_k=min(12, k))
    n = args.n

    # --- 1/2: k-mer access ------------------------------------------------
    t0 = time.perf_counter()
    ss = sb.select_support()
    print(f"select support built in {time.perf_counter()-t0:.2f}s", flush=True)
    checksum = 0
    t0 = time.perf_counter()
    step = max(1, sb.number_of_subsets() // n)
    count = 0
    for col in range(1, sb.number_of_subsets(), step * 997):
        checksum += len(sb.get_kmer_fast(col, ss))
        count += 1
        if count >= min(n, 2000):  # host-side scalar path; sample it
            break
    dt = time.perf_counter() - t0
    print(f"select-access get_kmer: {dt*1e6/max(1,count):.3f} us/kmer "
          f"(sampled {count}, checksum {checksum})", flush=True)

    t0 = time.perf_counter()
    all_kmers = sb.reconstruct_all_kmers()
    dt = time.perf_counter() - t0
    print(f"reconstruct_all_kmers: {dt*1e6/sb.number_of_subsets():.4f} us/kmer "
          f"(all {sb.number_of_subsets()}, len {len(all_kmers)})", flush=True)

    # --- 3: individual search --------------------------------------------
    starts = rng.integers(0, len(genome) - k, size=n)
    kmers = np.stack([encode_query(genome[s : s + k]) for s in starts]).astype(np.int8)
    kd = jnp.asarray(kmers)
    out = search_jit(sb.device_index, kd)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        out = search_jit(sb.device_index, kd)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    print(f"individual search: {dt*1e6/(n*reps):.4f} us/query "
          f"({n*reps/dt/1e6:.1f}M q/s, checksum {int(np.asarray(out).sum())})",
          flush=True)

    # --- 4/5: streaming search -------------------------------------------
    read_len = 100
    n_reads = max(256, n // (read_len - k + 1))
    rstarts = rng.integers(0, len(genome) - read_len, size=n_reads)
    reads = np.stack(
        [encode_query(genome[s : s + read_len]) for s in rstarts]
    ).astype(np.int8)
    lengths = np.full(n_reads, read_len, dtype=np.int32)
    rd, ld = jnp.asarray(reads), jnp.asarray(lengths)
    nq = n_reads * (read_len - k + 1)

    out = streaming_search_jit(sb.device_index, rd, ld)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = streaming_search_jit(sb.device_index, rd, ld)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    print(f"streaming search (LF): {dt*1e6/(nq*reps):.4f} us/query "
          f"({nq*reps/dt/1e6:.1f}M q/s, checksum {int(np.asarray(out).sum())})",
          flush=True)

    for arity in (2, 3):
        turbo = build_turbo(sb.device_index, arity=arity)
        out = turbo_streaming_jit(turbo, sb.device_index, rd, ld)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = turbo_streaming_jit(turbo, sb.device_index, rd, ld)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        print(f"streaming search (turbo, arity {arity}): "
              f"{dt*1e6/(nq*reps):.4f} us/query "
              f"({nq*reps/dt/1e6:.1f}M q/s, checksum {int(np.asarray(out).sum())})",
              flush=True)


if __name__ == "__main__":
    main()
