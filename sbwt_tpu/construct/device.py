"""On-device SBWT construction: the whole pipeline as jit sort/join
programs.

The reference's construction is KMC + external-memory sort + cursor-stream
merges on the host (kmc_construct.hh:102-238, EM_sort/).  The host-side
numpy port of that lives in construct/inmemory.py; THIS module is the
device-native path: window packing, colex sort, dedup, out-edge joins,
dummy-prefix emission and rank-table packing all run as one compiled XLA
program over static padded shapes — no data-dependent shapes anywhere
(counts ride along as device scalars; the only host round trips are tiny
scalar fetches at the end).

Design notes:

* k-mers are W = ceil(k/16) uint32 words, top-aligned (char at distance d
  from the END at bits [30-2*(d%16), 31-2*(d%16)] of word d//16, word 0
  most significant) so word-sequence unsigned compare == colex compare;
  `lax.sort` with num_keys = W (+1 for the length tiebreak) gives the
  multi-word ordering without x64.  Any k <= 255 (the reference's
  MAX_KMER_LENGTH ceiling) works; W is a static compile parameter.
* Sorted-set membership (out-edge probes, predecessor tests) is done with
  the merge trick — concatenate tagged keys, one multi-key sort, then
  propagate each equal-key run's leading tag — because there is no
  multi-key searchsorted on device.
* Dummy prefixes are emitted into a STATIC slot budget (`src_pad`
  sources): genomes have a handful of sources (k-mers without a
  predecessor), read sets roughly one per read.  If the input exceeds the
  budget the builder raises and the caller falls back to the host path.
* Everything downstream of the big sort stays padded to static shapes;
  the final MatrixIndex simply carries zero-padded rank tables (queries
  never gather past column n_nodes - 1, so padding is invisible), with
  the true n_nodes fetched as one scalar.

Differentially tested against construct/inmemory.build_sbwt (the oracle)
in tests/test_device_build.py.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

_SENT = np.uint32(0xFFFFFFFF)


def _n_key_words(k: int) -> int:
    return -(-k // 16)


def _pack_bits_words(b, n_words):
    """bool [T] -> uint32 [n_words] little-bit-order words (T <= 32*n_words)."""
    T = b.shape[0]
    b = jnp.pad(b, (0, n_words * 32 - T))
    w = b.reshape(-1, 32).astype(jnp.uint32) << jnp.arange(32, dtype=jnp.uint32)
    return w.sum(axis=1, dtype=jnp.uint32)


def _rank_rows(words):
    """uint32 words -> int32 [W, 2] (word, exclusive cumulative popcount)."""
    pc = jax.lax.population_count(words).astype(jnp.int32)
    cum = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(pc)[:-1]])
    return jnp.stack([words.astype(jnp.int32), cum], axis=1)


# ---------------------------------------------------------------------------
# W-word key helpers: values are python lists of W uint32 arrays, word 0
# most significant.  Char at distance d from the end lives in word d//16
# at bits [30-2*(d%16), 31-2*(d%16)].
# ---------------------------------------------------------------------------


def _word_bit_of_distance(d: int):
    return d // 16, 30 - 2 * (d % 16)


def _drop_first(ws, k):
    """Clear the first char (distance k-1 from the end) of length-k keys."""
    wi, b = _word_bit_of_distance(k - 1)
    out = list(ws)
    out[wi] = ws[wi] & np.uint32(~(3 << b) & 0xFFFFFFFF)
    return out


def _shift_left2(ws):
    """Multi-word left shift by 2 bits (Kmer::dropright semantics)."""
    W = len(ws)
    out = []
    for i in range(W):
        nxt = (ws[i + 1] >> 30) if i + 1 < W else jnp.zeros_like(ws[i])
        out.append((ws[i] << 2) | nxt)
    return out


def _append_last(ws, c):
    """Multi-word right shift by 2, then set the top char to c."""
    W = len(ws)
    c = c.astype(jnp.uint32) if hasattr(c, "astype") else jnp.uint32(c)
    out = []
    for i in range(W):
        prev = (ws[i - 1] & 3) << 30 if i > 0 else (c << 30)
        out.append((ws[i] >> 2) | prev)
    return out


def _prefix(ws, k, length):
    """Keys of the first `length` chars of length-k keys — static left
    shift by s = 2*(k-length) bits across words."""
    s = 2 * (k - length)
    W = len(ws)
    wshift, bshift = s // 32, s % 32
    out = []
    for i in range(W):
        j = i + wshift
        cur = ws[j] if j < W else None
        nxt = ws[j + 1] if j + 1 < W else None
        if cur is None:
            out.append(jnp.zeros_like(ws[i]))
        elif bshift == 0:
            out.append(cur)
        else:
            lopart = (nxt >> (32 - bshift)) if nxt is not None else jnp.zeros_like(cur)
            out.append((cur << bshift) | lopart)
    return out


def _char_at(ws, d):
    """Char code at distance d (static) from the end."""
    wi, b = _word_bit_of_distance(d)
    return ((ws[wi] >> b) & 3).astype(jnp.int32)


def _where_list(cond, ws_true, ws_false_val):
    return [jnp.where(cond, w, ws_false_val) for w in ws_true]


def _neq_prev(ws):
    """Element != its left neighbor (rolled), OR-ed across words."""
    out = None
    for w in ws:
        d = w != jnp.roll(w, 1)
        out = d if out is None else (out | d)
    return out


def _scatter_list(ws, tgt, src_ws, size_fill):
    return [w.at[tgt].set(s, mode="drop") for w, s in zip(ws, src_ws)]


def _member_sorted(a_ws, a_n, q_ws, q_valid):
    """Membership of queries in a sorted-distinct list, via one merge sort.

    a_ws: W-word sorted distinct keys compacted to the front (first a_n
    real).  q_ws: query keys (any order), q_valid masks live queries.
    Returns bool [len(q)] — query key present among the first a_n a-keys.
    """
    W = len(a_ws)
    m_a, m_q = a_ws[0].shape[0], q_ws[0].shape[0]
    in_a = jnp.arange(m_a) < a_n
    keys = [
        jnp.concatenate([jnp.where(in_a, a_ws[i], _SENT), jnp.where(q_valid, q_ws[i], _SENT)])
        for i in range(W)
    ]
    tag = jnp.concatenate([jnp.zeros(m_a, jnp.uint32), jnp.ones(m_q, jnp.uint32)])
    src = jnp.concatenate(
        [jnp.full(m_a, m_q, jnp.int32), jnp.arange(m_q, dtype=jnp.int32)]
    )
    sorted_ops = lax.sort((*keys, tag, src), num_keys=W + 1)
    skeys, stag, ssrc = sorted_ops[:W], sorted_ops[W], sorted_ops[W + 1]
    # a query hits iff its equal-key RUN starts with an a-entry (a-keys are
    # distinct and sort first within a run; queries may repeat — e.g.
    # predecessor probes of k-mers sharing a (k-1)-prefix — so propagate
    # the run-start tag with a cummax instead of checking one neighbor)
    tot = m_a + m_q
    i = jnp.arange(tot, dtype=jnp.int32)
    run_start = (i == 0) | _neq_prev(skeys)
    enc = jnp.where(run_start, 2 * i + (stag == 0), -1)
    first_is_a = (lax.cummax(enc) & 1) == 1
    hit_here = first_is_a & (stag == 1)
    out = jnp.zeros(m_q, dtype=bool)
    out = out.at[ssrc].max(hit_here, mode="drop")
    return out & q_valid


@partial(jax.jit, static_argnames=("k", "src_pad", "streaming", "n_words"))
def _build_device_jit(codes, k, src_pad, streaming, n_words):
    """The construction program.  codes int8 [Ntot] (-1 separates/pads).

    Returns (rank_tbl [4*n_words, 2] i32, sgs_tbl [n_words, 2] i32,
    C i32 [4], n_nodes i32, n_kmers i32, n_src i32)."""
    Ntot = codes.shape[0]
    W = _n_key_words(k)
    m = Ntot - k + 1
    u = (codes & 3).astype(jnp.uint32)

    # ---- pack windows (k static shifted elementwise passes) ------------
    ws = [jnp.zeros(m, jnp.uint32) for _ in range(W)]
    for j in range(k):
        wi, b = _word_bit_of_distance(k - 1 - j)
        w = lax.dynamic_slice(u, (j,), (m,))
        ws[wi] = ws[wi] | (w << b)
    bad = (codes < 0).astype(jnp.int32)
    cs = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    ws = _where_list(valid, ws, _SENT)

    # ---- colex sort + dedup -------------------------------------------
    sws = list(lax.sort(tuple(ws), num_keys=W))
    n_valid = jnp.sum(valid.astype(jnp.int32))
    idx = jnp.arange(m, dtype=jnp.int32)
    newk = ((idx == 0) | _neq_prev(sws)) & (idx < n_valid)
    # compact distinct keys to the front (cumsum scatter, ops/search.py style)
    pos = jnp.cumsum(newk.astype(jnp.int32)) - 1
    n = jnp.where(m > 0, pos[-1] + 1, 0)  # distinct k-mer count
    tgt = jnp.where(newk, pos, m)
    dv = _scatter_list([jnp.full(m, _SENT) for _ in range(W)], tgt, sws, m)
    in_n = idx < n

    # ---- suffix groups among k-mers -----------------------------------
    sf = _drop_first(dv, k)
    gstart = ((idx == 0) | _neq_prev(sf)) & in_n

    # ---- out-edges: probe rep-suffix . c against the k-mer set --------
    kmer_bits = []
    for c in range(4):
        y = _append_last(sf, jnp.uint32(c))
        present = _member_sorted(dv, n, y, gstart)
        # only the rep column carries the group's edge bit (subset structure)
        kmer_bits.append(present & gstart)

    # ---- sources: k-mers whose (k-1)-predecessor suffix is absent -----
    n_rep = jnp.sum(gstart.astype(jnp.int32))
    rpos = jnp.cumsum(gstart.astype(jnp.int32)) - 1
    rtgt = jnp.where(gstart, rpos, m)
    rs = _scatter_list([jnp.full(m, _SENT) for _ in range(W)], rtgt, sf, m)
    preds = _shift_left2(dv)
    has_pred = _member_sorted(rs, n_rep, preds, in_n)
    is_src = in_n & ~has_pred
    n_src = jnp.sum(is_src.astype(jnp.int32))
    spos = jnp.cumsum(is_src.astype(jnp.int32)) - 1
    stgt = jnp.where(is_src, spos, src_pad)
    src = _scatter_list([jnp.full(src_pad, _SENT) for _ in range(W)], stgt, dv, src_pad)
    src_ok = jnp.arange(src_pad) < n_src

    # ---- dummy prefixes (static unroll over lengths k-1..0) -----------
    D = src_pad * k + 1
    parts = [[] for _ in range(W)]
    parts_len, parts_edge, parts_ok = [], [], []
    for l in range(k - 1, -1, -1):
        pw = _prefix(src, k, l)
        for i in range(W):
            parts[i].append(pw[i])
        parts_len.append(jnp.full(src_pad, l, jnp.int32))
        # the edge char = source char at index l = distance k-1-l from end
        parts_edge.append(_char_at(src, k - 1 - l))
        parts_ok.append(src_ok)
    # + the root (always exists, initially edge-less)
    for i in range(W):
        parts[i].append(jnp.zeros(1, jnp.uint32))
    parts_len.append(jnp.zeros(1, jnp.int32))
    parts_edge.append(jnp.full(1, -1, jnp.int32))
    parts_ok.append(jnp.ones(1, bool))
    dd = [jnp.concatenate(p) for p in parts]
    dd_len = jnp.concatenate(parts_len)
    dd_edge = jnp.concatenate(parts_edge)
    dd_ok = jnp.concatenate(parts_ok)
    dd = _where_list(dd_ok, dd, _SENT)
    dd_lenk = jnp.where(dd_ok, dd_len.astype(jnp.uint32), jnp.uint32(0xFFFF))

    # ---- dedup dummies by (val, len), OR-ing edges --------------------
    sorted_d = lax.sort((*dd, dd_lenk, dd_edge), num_keys=W + 1)
    sd, sd_len, sd_edge = list(sorted_d[:W]), sorted_d[W], sorted_d[W + 1]
    di = jnp.arange(D, dtype=jnp.int32)
    n_dd = jnp.sum(dd_ok.astype(jnp.int32))
    dnew = ((di == 0) | _neq_prev(sd) | (sd_len != jnp.roll(sd_len, 1))) & (di < n_dd)
    dgid = jnp.cumsum(dnew.astype(jnp.int32)) - 1
    n_d = jnp.where(n_dd > 0, jnp.maximum(dgid[-1] + 1, 0), 0)
    dtgt = jnp.where(dnew, dgid, D)
    du = _scatter_list([jnp.full(D, _SENT) for _ in range(W)], dtgt, sd, D)
    du_len = jnp.full(D, jnp.uint32(0xFFFF)).at[dtgt].set(sd_len, mode="drop")
    du_bits = []
    for c in range(4):
        bc = jnp.zeros(D, dtype=bool)
        live = di < n_dd
        bc = bc.at[jnp.where(live, dgid, D)].max(sd_edge == c, mode="drop")
        du_bits.append(bc)

    # ---- final merge of dummies + k-mers ------------------------------
    T = m + D
    a_ws = [jnp.concatenate([du[i], dv[i]]) for i in range(W)]
    a_len = jnp.concatenate([du_len, jnp.where(in_n, jnp.uint32(k), jnp.uint32(0xFFFF))])
    a_bits = [
        jnp.concatenate([du_bits[c], kmer_bits[c]]).astype(jnp.uint32)
        for c in range(4)
    ]
    merged = lax.sort((*a_ws, a_len, *a_bits), num_keys=W + 1)
    nm = list(merged[:W])
    nm_len = merged[W]
    b4 = merged[W + 1 : W + 5]
    n_nodes = n + n_d
    ti = jnp.arange(T, dtype=jnp.int32)
    node_ok = ti < n_nodes
    bits = [(b.astype(bool) & node_ok) for b in b4]

    # ---- streaming support over all nodes -----------------------------
    if streaming:
        full = nm_len == k
        kdrop = _drop_first(nm, k)
        sh = [jnp.where(full, kdrop[i], nm[i]) for i in range(W)]
        sh_len = jnp.where(full, jnp.uint32(k - 1), nm_len)
        sgs = ((ti == 0) | _neq_prev(sh) | (sh_len != jnp.roll(sh_len, 1))) & node_ok
    else:
        sgs = jnp.zeros(T, dtype=bool)

    # ---- rank tables ---------------------------------------------------
    rank_tbl = jnp.concatenate(
        [_rank_rows(_pack_bits_words(bits[c], n_words)) for c in range(4)]
    )
    sgs_words = _pack_bits_words(sgs, n_words)
    sgs_tbl = jnp.stack(
        [
            sgs_words.astype(jnp.int32),
            jnp.concatenate([jnp.zeros(1, jnp.int32), sgs_words[:-1].astype(jnp.int32)]),
        ],
        axis=1,
    )
    counts = jnp.stack([jnp.sum(b, dtype=jnp.int32) for b in bits])
    C = jnp.concatenate([jnp.ones(1, jnp.int32), jnp.cumsum(counts)[:-1] + 1])
    n_kmers = n
    return rank_tbl, sgs_tbl, C, n_nodes, n_kmers, n_src


def _round_up(x: int, quantum: int) -> int:
    return -(-x // quantum) * quantum


def prepare_device_codes(
    seqs, k: int, pad_quantum: int = 1 << 20, src_pad: int | None = None
):
    """Flatten + pad sequences for the device builder and upload once.

    Returns (codes_device, src_pad, n_words) — reusable across repeat
    builds (benchmarks re-time the compiled program without re-paying the
    host-to-device upload)."""
    from ..utils.dna import encode

    if k > 255:
        raise ValueError("k > 255 exceeds the reference's MAX_KMER_LENGTH ceiling")
    parts = []
    for s in seqs:
        codes = s if isinstance(s, np.ndarray) else encode(s)
        parts.append(codes.astype(np.int8))
        parts.append(np.full(1, -1, dtype=np.int8))  # separator
    flat = np.concatenate(parts) if parts else np.full(1, -1, dtype=np.int8)
    Ntot = _round_up(max(len(flat), k + 1), pad_quantum)
    buf = np.full(Ntot, -1, dtype=np.int8)
    buf[: len(flat)] = flat

    m = Ntot - k + 1
    if src_pad is None:
        src_pad = max(1024, min(m, len(parts) // 2 + m // 16))
    n_words = (m + src_pad * k + 1) // 32 + 1
    return jnp.asarray(buf), src_pad, n_words


def build_sbwt_device(
    seqs,
    k: int,
    streaming_support: bool = True,
    precalc_k: int = 0,
    src_pad: int | None = None,
    pad_quantum: int = 1 << 20,
    prepared=None,
):
    """Build a plain-matrix MatrixIndex ON DEVICE from sequences.

    seqs: list of str / int8 code arrays; any k <= 255 (key width is
    ceil(k/16) uint32 words, a static compile parameter).  Construction
    runs as one compiled program (see module docstring); input length is
    padded to `pad_quantum` so repeat builds of similar sizes reuse the
    compile.  `prepared` (from prepare_device_codes) skips the flatten +
    upload.

    Raises ValueError when the source budget overflows (inputs with more
    predecessor-less k-mers than src_pad — extremely fragmented inputs);
    callers should fall back to the host builder then.
    """
    from ..models.matrix import MatrixIndex, with_precalc

    buf_d, src_pad, n_words = (
        prepared
        if prepared is not None
        else prepare_device_codes(seqs, k, pad_quantum, src_pad)
    )
    rank_tbl, sgs_tbl, C, n_nodes, n_kmers, n_src = _build_device_jit(
        buf_d, k, src_pad, bool(streaming_support), n_words
    )
    n_src = int(n_src)
    if n_src > src_pad:
        raise ValueError(
            f"device build source budget exceeded ({n_src} > {src_pad}); "
            "use the host builder or raise src_pad"
        )
    index = MatrixIndex(
        rank_tbl=rank_tbl,
        sgs_tbl=sgs_tbl if streaming_support else jnp.zeros((1, 2), jnp.int32),
        C=C,
        precalc=jnp.zeros((1, 2), dtype=jnp.int32),
        n_nodes=int(n_nodes),
        n_kmers=int(n_kmers),
        k=int(k),
        precalc_k=0,
        n_words=n_words,
        has_streaming=bool(streaming_support),
    )
    if precalc_k > 0:
        index = with_precalc(index, precalc_k)
    return index
