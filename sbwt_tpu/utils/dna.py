"""DNA alphabet encoding utilities.

Device-native equivalent of the reference lookup tables in
include/sbwt/globals.hh:19-53 (ACGT<->0123 and reverse-complement tables).
Everything here is vectorized numpy; the device side only ever sees int8
code arrays produced by these functions.
"""
from __future__ import annotations

import numpy as np

ALPHABET = "ACGT"

# ACGT -> 0..3, everything else -> -1 (mirrors from_ACGT_to_0123_lookup_table,
# globals.hh:38-39: only uppercase 'A','C','G','T' are valid).
_CHAR_TO_CODE = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate(ALPHABET):
    _CHAR_TO_CODE[ord(_c)] = _i

# 0..3 -> ACGT (globals.hh:42)
CODE_TO_CHAR = np.frombuffer(b"ACGT", dtype=np.uint8).copy()

# Query encoding: uppercase ACGT -> 0..3, lowercase acgt -> 4..7, other -> -1.
# This keeps both of the reference's semantics recoverable from one array:
# per-k-mer search treats lowercase as invalid (SBWT.hh:426-427 passes the
# raw character to get_char_idx) while the streaming extension step
# uppercases first (SBWT.hh:565-566), i.e. code & 3 with validity code >= 0.
_CHAR_TO_QUERY_CODE = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate(ALPHABET):
    _CHAR_TO_QUERY_CODE[ord(_c)] = _i
    _CHAR_TO_QUERY_CODE[ord(_c.lower())] = _i + 4


def encode_query(seq: bytes | str | np.ndarray) -> np.ndarray:
    """Encode query text: ACGT -> 0..3, acgt -> 4..7, other -> -1."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray)):
        arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        arr = np.asarray(seq, dtype=np.uint8)
    return _CHAR_TO_QUERY_CODE[arr]


# Reverse complement over raw bytes: uppercase->uppercase, lowercase->lowercase,
# non-ACGT maps to itself (globals.hh:19-35).
_RC_TABLE = np.arange(256, dtype=np.uint8)
for _a, _b in [(b"A", b"T"), (b"C", b"G"), (b"a", b"t"), (b"c", b"g")]:
    _RC_TABLE[ord(_a)] = ord(_b)
    _RC_TABLE[ord(_b)] = ord(_a)


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """Encode a DNA sequence to int8 codes: A,C,G,T -> 0..3, other -> -1.

    Matches the reference's per-kmer search validity rule: only uppercase
    ACGT are valid query characters (SBWT.hh:426-427 passes the raw char to
    get_char_idx, so lowercase is invalid there too).
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray)):
        arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        arr = np.asarray(seq, dtype=np.uint8)
    return _CHAR_TO_CODE[arr]


def decode(codes: np.ndarray) -> str:
    """Decode int8 codes 0..3 back to an ACGT string."""
    codes = np.asarray(codes)
    if np.any((codes < 0) | (codes > 3)):
        raise ValueError("decode: codes out of range 0..3")
    return CODE_TO_CHAR[codes].tobytes().decode("ascii")


def reverse_complement_bytes(seq: bytes) -> bytes:
    """Reverse complement of a raw byte sequence (rc_table semantics)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _RC_TABLE[arr][::-1].tobytes()


def reverse_complement(seq: str) -> str:
    return reverse_complement_bytes(seq.encode("ascii")).decode("ascii")
