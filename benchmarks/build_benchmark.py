"""Construction benchmark: index-build throughput (Mbp/s).

The reference's heavy path is KMC + EM-sort construction (SURVEY §3.1);
this measures our two pipelines on synthetic genomes:

  1. in-memory vectorized build (construct/inmemory.py),
  2. external build: spill -> native EM sort -> streaming dedup ->
     chunked bit-matrix emit (construct/external.py + streaming.py),

reporting Mbp/s and distinct-kmer rates.  Host-side (numpy + native C);
JAX is not involved until device upload, so this runs anywhere.

Usage: python benchmarks/build_benchmark.py [--mbp 16] [--k 30] [--threads 2]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=16.0)
    ap.add_argument("--k", type=int, default=30)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--ram-mb", type=int, default=512)
    ap.add_argument("--with-device", action="store_true",
                    help="also time SBWT on-device construction (uploads the "
                         "corpus to the device once, then times the compiled build)")
    args = ap.parse_args()

    from sbwt_tpu.construct.inmemory import build_sbwt
    from sbwt_tpu.construct.external import build_sbwt_external

    rng = np.random.default_rng(1)
    n = int(args.mbp * 1e6)
    # 16 chromosomes so the spill phase streams per-sequence chunks
    seqs = [rng.integers(0, 4, size=n // 16, dtype=np.int8) for _ in range(16)]

    # warmup pass: the first build faults in GBs of lazily-backed pages
    # (a VM artifact — measured 12.2 s cold vs 3.4 s warm for the same
    # 16 Mbp in-memory build); the timed passes measure the algorithm
    build_sbwt(seqs, args.k)
    t0 = time.perf_counter()
    mem = build_sbwt(seqs, args.k)
    t_mem = time.perf_counter() - t0

    build_sbwt_external(
        seqs, args.k, ram_bytes=args.ram_mb << 20, n_threads=args.threads
    )
    t0 = time.perf_counter()
    ext = build_sbwt_external(
        seqs, args.k, ram_bytes=args.ram_mb << 20, n_threads=args.threads
    )
    t_ext = time.perf_counter() - t0

    assert np.array_equal(mem.bits, ext.bits)
    out = {
        "metric": "build_mbp_per_sec",
        "k": args.k,
        "input_mbp": args.mbp,
        "n_kmers": int(mem.n_kmers),
        "in_memory": {"seconds": round(t_mem, 2), "mbp_per_s": round(args.mbp / t_mem, 2)},
        "external": {
            "seconds": round(t_ext, 2),
            "mbp_per_s": round(args.mbp / t_ext, 2),
            "ram_mb": args.ram_mb,
            "threads": args.threads,
        },
    }
    if args.with_device:
        import jax

        from sbwt_tpu.construct.device import build_sbwt_device, prepare_device_codes
        from sbwt_tpu.utils.compile_cache import configure_compile_cache

        configure_compile_cache()

        prep = prepare_device_codes(seqs, args.k)
        jax.block_until_ready(prep[0])
        t0 = time.perf_counter()
        di = build_sbwt_device(seqs, args.k, prepared=prep)
        cold = time.perf_counter() - t0  # compile + run (upload already paid)
        assert di.n_kmers == int(mem.n_kmers)
        t0 = time.perf_counter()
        di = build_sbwt_device(seqs, args.k, prepared=prep)
        jax.block_until_ready(di.rank_tbl)
        warm = time.perf_counter() - t0
        d0 = jax.devices()[0]
        out["device"] = {
            "platform": d0.platform,
            "kind": d0.device_kind,
            "cold_seconds": round(cold, 2),
            "seconds": round(warm, 2),
            "mbp_per_s": round(args.mbp / warm, 2),
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
