"""Device memory headroom probes for capacity-aware engine selection.

The turbo successor tables (ops/turbo.py) cost 16 B (arity 1), 128 B
(arity 2) or 1 KiB (arity 3) of device memory per column; auto mode must
degrade 3 -> 2 -> 1 -> LF based on *measured* free memory instead of
OOM-killing the CLI (the reference never OOMs here because it has no such
table — graceful degradation is the parity-preserving behavior)."""
from __future__ import annotations

import os

import jax

# build workspace + run-time arrays need room too; never plan to fill
# more than this fraction of free memory with the turbo table
HEADROOM_FRACTION = 0.5

# The k <= 32 window side table of the turbo block sweep (ops/turbo.py)
# holds 8 B per query position; with its build transients (the packed
# remainder words and the two shifted word planes) and the answer arrays
# it keeps alive, a position costs about this many bytes while the sweep
# runs.  The int64 engine's answer arrays are twice as wide.
WIN2_BYTES_PER_POSITION = 32
WIN2_BYTES_PER_POSITION_WIDE = 48


def device_free_bytes(device=None) -> int:
    """Free memory of a device in bytes.

    GPU backends report their allocator's pool via memory_stats()
    (`bytes_limit` is the pool JAX reserved, not the card's total); the
    CPU backend allocates from host RAM, measured via sysconf.  A device
    that reports neither is an error: guessing a size would hide the
    device from the capacity planning that depends on it."""
    d = device or jax.devices()[0]
    try:
        stats = d.memory_stats()
    except (RuntimeError, NotImplementedError):
        stats = None
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))
    if d.platform == "cpu":
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    raise RuntimeError(
        f"cannot measure free memory of device {d} (platform {d.platform!r}): "
        "memory_stats() reports no bytes_limit"
    )


def win2_side_table_fits(n_positions: int, wide: bool = False, free_bytes: int | None = None) -> bool:
    """Whether the turbo sweep's k <= 32 window side table for
    `n_positions` query positions fits in HEADROOM_FRACTION of free
    device memory; otherwise the packed-words path (no side table)
    serves the batch."""
    if free_bytes is None:
        free_bytes = device_free_bytes()
    per = WIN2_BYTES_PER_POSITION_WIDE if wide else WIN2_BYTES_PER_POSITION
    return n_positions * per <= int(free_bytes * HEADROOM_FRACTION)


def turbo_table_bytes(
    n_nodes: int, arity: int, precalc_k: int = 0, wide: bool = False
) -> int:
    """Device-memory cost of the turbo engine's tables (ops/turbo.py):
    the successor table (arity 1 = int32 [n, 4] rows, 16 B/col;
    arity 2/3 = int32 [n * 4^arity, width] with width 2 or 4) plus the
    seed-liveness pair bitmap (2 bits per (p+1)-mer, built whenever
    0 < precalc_k <= 14 — 67 MB at p=13).  A wide (int64) index only has
    the arity-1 pair-row tier: [n, 8] int32 (lo, hi) rows = 32 B/col
    (ops/turbo.py WideTurboIndex) regardless of the requested arity."""
    if wide:
        tbl = n_nodes * 32
    elif arity == 1:
        tbl = n_nodes * 16
    else:
        width = 2 if arity == 2 else 4
        tbl = n_nodes * (4**arity) * width * 4
    if 0 < precalc_k <= 14:
        tbl += 4 ** (precalc_k + 1) // 4
    return tbl


def select_turbo_arity(
    n_nodes: int, free_bytes: int | None = None, precalc_k: int = 0,
    wide: bool = False,
) -> int | None:
    """Largest affordable turbo arity (3, 2, 1) or None for the LF engine.

    free_bytes defaults to the measured free memory of the default device;
    the table may take at most HEADROOM_FRACTION of it."""
    if free_bytes is None:
        free_bytes = device_free_bytes()
    budget = int(free_bytes * HEADROOM_FRACTION)
    if wide:
        # the wide engine's only tier is the arity-1 [n, 8] pair-row
        # table (32 B/col); account for IT, not the narrow 16 B rows
        return 1 if turbo_table_bytes(n_nodes, 1, precalc_k, wide=True) <= budget else None
    for arity in (3, 2, 1):
        if arity >= 2 and n_nodes * (4**arity) >= 2**31:
            continue  # flat row index would overflow int32 (ops/turbo.py)
        if turbo_table_bytes(n_nodes, arity, precalc_k) <= budget:
            return arity
    return None
