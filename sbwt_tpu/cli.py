"""Command-line interface: build / search / build-variant / ascii-export.

Same subcommands and flags as the reference dispatcher
(src/CLI/sbwt.cpp:10-59) and its four commands (src/CLI/sbwt_build.cpp,
sbwt_search.cpp, sbwt_build_from_plain_matrix.cpp, sbwt_ascii_export.cpp).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .utils.logging import LogLevel, set_log_level, write_log

MAX_KMER_LENGTH = 255  # the reference's compile-time ceiling (CMakeLists.txt:71-81)


def _readlines(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _input_file_list(arg: str) -> list[str]:
    if arg.endswith(".txt"):
        return _readlines(arg)
    return [arg]


def build_main(argv) -> int:
    p = argparse.ArgumentParser(prog="sbwt-tpu build", description="Construct an SBWT variant.")
    p.add_argument("-i", "--in-file", required=True)
    p.add_argument("-o", "--out-file", required=True)
    p.add_argument("-k", "--kmer-length", type=int, required=True)
    p.add_argument("-p", "--precalc-length", type=int, default=8)
    p.add_argument("--variant", default="plain-matrix")
    p.add_argument("--add-reverse-complements", action="store_true")
    p.add_argument("--no-streaming-support", action="store_true")
    p.add_argument("-t", "--n-threads", type=int, default=1)
    p.add_argument("-a", "--min-abundance", type=int, default=1)
    p.add_argument("-b", "--max-abundance", type=int, default=1000000000)
    p.add_argument("-m", "--ram-gigas", type=int, default=2)
    p.add_argument("-d", "--temp-dir", default=".")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--format", choices=["cpp", "native"], default="cpp",
                   help="Index file format (default: cpp — follows the reference's "
                        ".sbwt layout for every variant; byte layouts are "
                        "reconstructed from sdsl-lite and semantically replica-"
                        "tested, but the wt_blcd/select_mcl sublayouts are "
                        "[assumed] — see docs/SDSL_LAYOUT.md for confidence notes)")
    args = p.parse_args(argv)

    from .io import seqio
    from .io.serialize import save, write_string
    from .models.sbwt import SBWT, VARIANT_NAMES

    if args.verbose:
        set_log_level(LogLevel.MINOR)
    if args.variant not in VARIANT_NAMES:
        sys.stderr.write(f"Error: unknown variant: {args.variant}\n")
        return 1
    k = args.kmer_length
    if k > MAX_KMER_LENGTH:
        sys.stderr.write(f"Error: k = {k} exceeds MAX_KMER_LENGTH = {MAX_KMER_LENGTH}\n")
        return 1
    precalc = min(args.precalc_length, k)
    if precalc != args.precalc_length:
        write_log(f"Warning: precalc length {args.precalc_length} is longer than k = {k}")
        write_log(f"Setting precalc length to {k}")

    input_files = _input_file_list(args.in_file)
    fmts = [seqio.figure_out_file_format(f) for f in input_files]
    if len({(f.format, f.gzipped) for f in fmts}) > 1:
        sys.stderr.write("Error: not all input files have the same format\n")
        return 1

    # The input side streams: sequences flow file -> bounded batches ->
    # encoded chunks -> k-mer spill, with reverse complements generated
    # per-chunk inside the builder — the corpus is never materialized in
    # RAM (the reference's KMC path likewise streams from disk,
    # kmc_construct.hh:206-238, and pre-writes RC *files*,
    # sbwt_build.cpp:115-122).  The auto method heuristic works from file
    # sizes, not a read list.
    input_bases = 0
    for f in input_files:
        import os as _os

        sz = _os.path.getsize(f)
        # decompressed-size estimate for the heuristic only (gzip of DNA
        # text compresses ~4x)
        input_bases += sz * 4 if f.endswith(".gz") else sz

    write_log("Building SBWT subset sequence")
    sbwt = SBWT.build(
        seqio.stream_build_codes(input_files),
        k,
        streaming_support=not args.no_streaming_support,
        precalc_k=precalc,
        min_abundance=args.min_abundance,
        max_abundance=args.max_abundance if args.max_abundance < 10**9 else None,
        add_reverse_complements=args.add_reverse_complements,
        variant=args.variant,
        ram_bytes=args.ram_gigas << 30,
        n_threads=args.n_threads,
        temp_dir=args.temp_dir,
        input_bases=input_bases,
    )
    write_log(f"Built SBWT for {sbwt.number_of_kmers()} distinct k-mers")
    write_log(f"SBWT has {sbwt.number_of_subsets()} subsets")

    bytes_written = save(args.out_file, sbwt, args.format)
    write_log(f"Built variant {args.variant} to file {args.out_file}")
    write_log(
        "Space on disk: "
        f"{bytes_written * 8.0 / sbwt.number_of_subsets()} bits per column, "
        f"{bytes_written * 8.0 / max(1, sbwt.number_of_kmers())} bits per k-mer"
    )
    return 0


def search_main(argv) -> int:
    p = argparse.ArgumentParser(prog="sbwt-tpu search", description="Query all k-mers of all input reads.")
    p.add_argument("-o", "--out-file", required=True)
    p.add_argument("-i", "--index-file", required=True)
    p.add_argument("-q", "--query-file", required=True)
    p.add_argument("-z", "--gzip-output", action="store_true")
    p.add_argument("--engine",
                   choices=["auto", "lf", "turbo", "turbo1", "turbo2", "turbo3"],
                   default="auto",
                   help="query engine: LF rank engine, or the successor turbo "
                        "table (turbo1: 16 B device memory/column row tier; turbo2: "
                        "pairs, 128 B/column; turbo3: triples, 1 KiB/column; "
                        "turbo/auto pick the largest arity that fits measured "
                        "free device memory, degrading 3 -> 2 -> 1 -> LF)")
    args = p.parse_args(argv)

    t_start = time.perf_counter()
    set_log_level(LogLevel.MINOR)

    from .io.query_runner import run_query_files
    from .io.serialize import load

    multi = args.query_file.endswith(".txt")
    in_files = _readlines(args.query_file) if multi else [args.query_file]
    out_files = _readlines(args.out_file) if multi else [args.out_file]
    if len(in_files) != len(out_files):
        raise RuntimeError(
            f"Number of input and output files does not match ({len(in_files)} vs {len(out_files)})"
        )

    sbwt = load(args.index_file)
    write_log(f"Loaded the index variant {sbwt.variant}")
    # Any variant is turbo-eligible: the successor table is variant-
    # independent once built (ops/turbo.py build_turbo), so compressed
    # on-disk variants query at turbo speed too.  build_turbo raises
    # ValueError for the documented cases it does not serve (no
    # streaming support, no precalc table, an unknown arity, an int32
    # row-index overflow); only those fall back to the LF engine.  Any
    # other error (a compile failure, device out-of-memory) fails the
    # command instead of hiding behind a slow run.
    want_turbo = args.engine in ("turbo", "turbo1", "turbo2", "turbo3") or (
        args.engine == "auto" and sbwt.has_streaming_query_support()
    )
    if want_turbo:
        try:
            arity = {"turbo1": 1, "turbo2": 2, "turbo3": 3}.get(args.engine)
            # auto measures free device memory and degrades 3 -> 2 -> LF
            chosen = sbwt.enable_turbo(arity=arity)
            if chosen is None:
                write_log("Turbo table exceeds free device memory; using LF engine")
            else:
                write_log(f"Turbo successor engine enabled (arity {chosen})")
        except ValueError as e:
            sbwt._turbo = None
            write_log(f"Turbo engine unavailable ({e}); using LF engine")
    n = run_query_files(sbwt, in_files, out_files, args.gzip_output)
    total = time.perf_counter() - t_start
    if n:
        write_log(f"us/query end-to-end: {total * 1e6 / n}")
    return 0


def build_variant_main(argv) -> int:
    p = argparse.ArgumentParser(prog="sbwt-tpu build-variant",
                                description="Re-encode a plain-matrix index into another variant.")
    p.add_argument("-i", "--in-file", required=True)
    p.add_argument("-o", "--out-file", required=True)
    p.add_argument("--variant", default="plain-matrix")
    p.add_argument("--format", choices=["cpp", "native"], default="cpp")
    args = p.parse_args(argv)

    from .io.serialize import load, save
    from .models.sbwt import VARIANT_NAMES

    if args.variant not in VARIANT_NAMES:
        sys.stderr.write(f"Error: unknown variant: {args.variant}\n")
        return 1
    write_log("Reading input.")
    sbwt = load(args.in_file)
    if sbwt.variant != "plain-matrix":
        sys.stderr.write("Error: input index is not a plain-matrix SBWT\n")
        return 1
    write_log(f"Building variant {args.variant}")
    sbwt = sbwt.to_variant(args.variant)
    bytes_written = save(args.out_file, sbwt, args.format)
    write_log(f"Built variant {args.variant} to file {args.out_file}")
    write_log(
        "Space on disk: "
        f"{bytes_written * 8.0 / sbwt.number_of_subsets()} bits per column, "
        f"{bytes_written * 8.0 / max(1, sbwt.number_of_kmers())} bits per k-mer"
    )
    return 0


def ascii_export_main(argv) -> int:
    p = argparse.ArgumentParser(prog="sbwt-tpu ascii-export",
                                description="Export the index structure in ascii.")
    p.add_argument("-o", "--out-file", required=True)
    p.add_argument("-i", "--index-file", required=True)
    args = p.parse_args(argv)

    from .io.serialize import load

    sbwt = load(args.index_file)
    write_log(f"Loading and exporting the index variant {sbwt.variant}")
    if sbwt.variant.startswith("mef-"):
        # Match the reference CLI: mef variants refuse ascii export
        # (sbwt_ascii_export.cpp:66,80,89 — mod_ef_vector lacks access
        # there; our structures could export, but the UX is kept identical).
        sys.stderr.write("Error: ascii export not supported for mef variants\n")
        return 1
    with open(args.out_file, "w") as f:
        f.write(sbwt.ascii_export_metadata())
        f.write(sbwt.ascii_export_sets())
    return 0


COMMANDS = {
    "build": build_main,
    "search": search_main,
    "build-variant": build_variant_main,
    "ascii-export": ascii_export_main,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    write_log(f"Maximum k-mer length is set to {MAX_KMER_LENGTH}")
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write("Available commands:\n")
        for c in COMMANDS:
            sys.stderr.write(f"   sbwt-tpu {c}\n")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        sys.stderr.write(f"Invalid command: {cmd}\n")
        return 1
    from .utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    try:
        return COMMANDS[cmd](rest)
    except Exception as e:  # mirror the reference's top-level catch (sbwt.cpp:51-57)
        sys.stderr.write(f"Error: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
