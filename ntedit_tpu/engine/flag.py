"""Dense flag pass: the device-side hot loop.

For every window head of a draft contig this computes, in one fused jit
program over fixed-size chunks:

* canonical ntHash2 multi-hashes (prefix-scan rolling hash,
  ntedit_tpu.core.nthash.window_hashes),
* Bloom-filter presence (and CBF counts) via batched device-memory gathers,
* window validity (all bases accepted — ATGC/IUPAC),
* the reference's absence gate
  ``snv || !contains || (counting && count < p)``
  (/root/reference/ntedit.cpp:1806-1807).

This replaces the reference's per-base rolling scan — its throughput-
dominant path (one BF probe per clean base; see SURVEY.md §3.3) — with a
data-parallel pass at ~chunk granularity.  Sites that gate are sparse
(~0.1% on real drafts) and are repaired by the engine's repair pass; the
gate bitmap produced here has no false negatives by construction (device
probes are bit-identical to host probes; tests/test_bloom.py).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ntedit_tpu.core import bloom, nthash as nt
from ntedit_tpu.engine.config import ACCEPTED

# lookup table: accepted draft bases, case-folded (isAcceptedBase,
# ntedit.cpp:493-499)
_ACCEPTED_TAB = np.zeros(256, dtype=np.uint8)
for _c in ACCEPTED:
    _ACCEPTED_TAB[_c] = 1
    _ACCEPTED_TAB[_c + 32] = 1  # lowercase
# numpy constant (not jnp): inline-embedded at lowering, no device fetch
ACCEPTED_TAB = _ACCEPTED_TAB

# 32-bit membership mask over letter index (c & 0xDF) - 64: bit i set when
# chr(64 + i) is an accepted base (A..Z fit in bits 1..26)
_ACCEPTED_MASK = np.uint32(0)
for _c in ACCEPTED:
    _ACCEPTED_MASK |= np.uint32(1) << np.uint32(_c - 64)

# 4 Mbp chunks: ~12 dispatches at 50 Mbp.  The BF gather, not the
# program size, should bound the pass, so the chunk only sets the
# dispatch count and the per-chunk transient.  This value was chosen on
# an earlier accelerator and has not been measured on the H100 yet.
# Short contigs still pipeline 2+ deep via _effective_chunk's pow2 clamp.
DEFAULT_CHUNK = 1 << 22

# 2-bit base codes for the packed upload path: ACGT/acgt -> 0..3,
# everything else (IUPAC, N, junk) -> 255 = "exception", handled host-side
_CODE_TAB = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE_TAB[_c] = _i
    _CODE_TAB[_c + 32] = _i


def _accepted(seq):
    """isAcceptedBase (ntedit.cpp:493-499) as arithmetic: a mask shift
    instead of a [256]-table gather per position."""
    fold = seq.astype(jnp.int32) & 0xDF  # case-fold letters
    idx = (fold & 31).astype(jnp.uint32)
    hit = (jnp.uint32(_ACCEPTED_MASK) >> idx) & jnp.uint32(1)
    return (hit == 1) & (fold >= 65) & (fold <= 90)


def _window_all(flags, k: int, n: int):
    """AND over every width-k window of bool [L] -> [n], by doubling
    (same O(log k) construction as nthash._window_xor)."""
    levels = {1: flags}
    w = 1
    while 2 * w <= k:
        f = levels[w]
        levels[2 * w] = f[: -w or None] & f[w:]
        w *= 2
    acc = None
    pos = 0
    for w in sorted(levels, reverse=True):
        if k & w:
            piece = levels[w][pos : pos + n]
            acc = piece if acc is None else acc & piece
            pos += w
    return acc


@partial(jax.jit, static_argnames=("k", "snv", "min_threshold"))
def flag_chunk(seq, df: bloom.DeviceFilter, k: int, snv: bool, min_threshold: int):
    """seq: uint8 [C + k - 1] (chunk plus right halo).

    Returns (gate, present, count, valid), all [C]:
      present — k-mer in filter (CBF: count > 0)
      count   — CBF count (1/0 for plain BF)
      valid   — window contains only accepted bases
      gate    — reference absence gate AND valid
    """
    fh, rh = nt.window_hashes(seq, k)
    can = nt.canonical(fh, rh)
    # blocked filters consume the canonical hash directly (no multi-hash
    # mixing needed: the probe word+offsets are bit fields of it)
    hashes = [can] if df.blocked else nt.extend(can, k, df.hash_num)
    if df.counting:
        count = df.count(hashes)
        present = count > 0
    else:
        present = df.contains(hashes)
        count = jnp.where(present, np.uint8(1), np.uint8(0))
    n = seq.shape[0] - k + 1
    valid = _window_all(_accepted(seq), k, n)
    gate = jnp.full(n, snv) | ~present
    if df.counting and min_threshold > 1:
        gate = gate | (count < np.uint8(min_threshold))
    return gate & valid, present, count, valid


@partial(jax.jit, static_argnames=("k", "snv", "min_threshold"))
def flag_chunk_packed(seq, df: bloom.DeviceFilter, k: int, snv: bool,
                      min_threshold: int):
    """flag_chunk with the gate bitmap packed to uint32 words on device:
    [C] bools -> [C/32] words (little-endian bit order).  32x less
    device->host traffic.  C must be a multiple of 32 (the chunked driver
    pads)."""
    gate, _present, _count, _valid = flag_chunk(seq, df, k, snv, min_threshold)
    lanes = jnp.arange(32, dtype=jnp.uint32)
    b = gate.reshape(-1, 32).astype(jnp.uint32)
    return (b << lanes[None, :]).sum(axis=1, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# Packed-code dense pass (the production driver)
#
# The drivers below upload 2-bit base codes packed 16/uint32 (4x less
# host->device traffic than ASCII, one transfer per contig) and hash from
# codes on device (nthash.window_hashes_codes).  Non-ACGT draft bytes
# (IUPAC, N, junk) can't be coded in 2 bits; they are encoded as 'A',
# located host-side, and patched per the spec's isAcceptedBase semantics
# (_exception_hints): windows touching an accepted-IUPAC byte are
# force-added to the hint — the repair engine re-evaluates the gate at
# every hinted head with exact host hashes (native/repair.cpp:1044), so
# that superset only costs probes — while windows touching an UNaccepted
# byte are removed (the spec scan skips them; hinting them would make
# fast-forwarding engines repair where the sequential scan cannot).
# ---------------------------------------------------------------------------

def _halo_words(k: int) -> int:
    return (k - 2) // 16 + 1


def _effective_chunk(n: int, chunk: int) -> int:
    """Smallest power-of-two chunk >= n, clamped to [2^15, chunk]: short
    contigs (most of a real draft) don't pay the full-chunk program's
    padded compute, while every contig length still maps onto one of at
    most log2(chunk/2^15)+1 compiled shapes."""
    c = 1 << 15
    while c < n and c < chunk:
        c <<= 1
    return min(c, chunk)


def _halo_words_snv(k: int) -> int:
    """Halo for the site-data passes: window hashes are needed for heads
    up to chunk-1+k (the confirmation/verify scans roll k windows past a
    head), so the decode must cover chunk + 2k - 1 bases —
    ceil((2k-1)/16) halo words."""
    return (2 * k - 2) // 16 + 1


def _encode_packed(seq: np.ndarray, n: int, k: int, chunk: int,
                   halo_words: Optional[int] = None):
    """ASCII draft [L] -> (packed uint32 words, exception positions).

    The packed array covers every chunk slice [w0, w0 + chunk/16 + halo):
    codes are padded to (last_start + chunk)/16 + halo words.

    Hot path at scale (a 50 Mbp draft encodes every polish call): one
    table gather into a preallocated buffer, then SWAR word packing —
    with codes c0..c3 in one little-endian uint32 word,
    ``y = x | x>>6; z = y | y>>12`` leaves ``c0|c1<<2|c2<<4|c3<<6`` in
    the low byte — instead of four strided-view ORs (each a
    non-contiguous pass numpy executes ~5x slower than a sequential
    one)."""
    seq = np.asarray(seq, dtype=np.uint8)
    last_start = ((n - 1) // chunk) * chunk
    if halo_words is None:
        halo_words = _halo_words(k)
    need = last_start + chunk + 16 * halo_words
    from ntedit_tpu.io import native as _native

    enc = _native.encode_2bit(seq, need)
    if enc is not None:
        return enc
    m = min(len(seq), need)
    codes = np.zeros(need, dtype=np.uint8)
    np.take(_CODE_TAB, seq[:m], out=codes[:m])
    if int(codes.max(initial=0)) == 255:
        exc = np.flatnonzero(codes == 255).astype(np.int64)
        codes[exc] = 0
    else:
        exc = np.zeros(0, dtype=np.int64)
    x = codes.view("<u4")
    y = x >> np.uint32(6)
    y |= x
    z = y >> np.uint32(12)
    z |= y
    z &= np.uint32(255)
    packed8 = z.astype(np.uint8)
    return packed8.view("<u4"), exc


# ---------------------------------------------------------------------------
# Packed-draft device cache: repeated passes over the SAME draft (multi-mode
# runs, bench repeats, gate+cand pass pairs) skip both the host 2-bit encode
# and the host->device upload.  Keyed by object identity plus a content
# fingerprint (length + sampled bytes), so an in-place draft mutation
# invalidates the entry.  Capacity 2 device arrays (drafts pack 16x, so a
# 250 Mbp entry is ~63 MB of device memory).  NTEDIT_TPU_NO_PACK_CACHE=1
# disables.
# ---------------------------------------------------------------------------

from collections import OrderedDict as _OrderedDict

_PACK_CACHE: "dict" = _OrderedDict()
_PACK_CACHE_CAP = 2


def _fingerprint(seq: np.ndarray) -> tuple:
    a = np.asarray(seq)
    L = a.shape[0]
    mid = L // 2
    return (
        L,
        a[:64].tobytes(),
        a[mid : mid + 64].tobytes(),
        a[max(0, L - 64) :].tobytes(),
    )


def packed_device(seq: np.ndarray, n: int, k: int, chunk: int,
                  halo_words: Optional[int] = None):
    """(packed device words, exception positions) for one contig, cached."""
    import os

    if os.environ.get("NTEDIT_TPU_NO_PACK_CACHE") == "1":
        packed_np, exc = _encode_packed(seq, n, k, chunk, halo_words)
        return jnp.asarray(packed_np), exc
    key = (id(seq), _fingerprint(seq), k, chunk, n, halo_words)
    hit = _PACK_CACHE.get(key)
    if hit is not None:
        _PACK_CACHE.move_to_end(key)
        return hit
    packed_np, exc = _encode_packed(seq, n, k, chunk, halo_words)
    entry = (jnp.asarray(packed_np), exc)
    _PACK_CACHE[key] = entry
    while len(_PACK_CACHE) > _PACK_CACHE_CAP:
        _PACK_CACHE.popitem(last=False)
    return entry


def _exception_heads(exc: np.ndarray, n: int, k: int) -> np.ndarray:
    """Sorted head positions whose window [h, h+k) touches an exception."""
    if not exc.size:
        return np.zeros(0, dtype=np.int64)
    # interval union via prefix sum: [max(0, e-k+1), e+1) per exception
    delta = np.zeros(n + 1, dtype=np.int32)
    lo = np.maximum(exc - (k - 1), 0)
    hi = np.minimum(exc + 1, n)
    keep = lo < hi
    np.add.at(delta, lo[keep], 1)
    np.add.at(delta, hi[keep], -1)
    return np.flatnonzero(np.cumsum(delta[:-1]) > 0).astype(np.int64)


def _merge_heads(gates: np.ndarray, extra: np.ndarray) -> np.ndarray:
    if not extra.size:
        return gates
    return np.union1d(gates, extra)


def _exception_hints(seq: np.ndarray, exc: np.ndarray, n: int, k: int):
    """Split exception (non-ACGT) draft positions into the two hint sets
    matching the spec's isAcceptedBase semantics (oracle.py:391-409;
    /root/reference/ntedit.cpp:493-499):

    * ``iupac_heads`` — windows touching an accepted-IUPAC byte (R/Y/...)
      but NO unaccepted byte.  The spec scan hashes these with the IUPAC
      seed; the device hashed them with the 'A' substitute, so the
      computed gate is unreliable — force-hint them and let the engine
      re-evaluate each with exact host hashes (superset-safe).
    * ``bad_heads`` — windows touching an unaccepted byte (N, junk).  The
      spec scan NEVER gates these (it skips to the next fully-accepted
      k-mer), and hinting them would make hint-fast-forwarding engines
      land and repair where the sequential scan cannot — they must be
      REMOVED from the device gates (the 'A' substitution makes the
      device probe spuriously gate there).
    """
    if not exc.size:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    acc = ACCEPTED_TAB[np.asarray(seq, np.uint8)[exc]] == 1
    bad_heads = _exception_heads(exc[~acc], n, k)
    iupac_heads = _exception_heads(exc[acc], n, k)
    if bad_heads.size and iupac_heads.size:
        iupac_heads = np.setdiff1d(iupac_heads, bad_heads, assume_unique=True)
    return iupac_heads, bad_heads


def _apply_exceptions(gates: np.ndarray, iupac_heads: np.ndarray,
                      bad_heads: np.ndarray) -> np.ndarray:
    if bad_heads.size:
        gates = np.setdiff1d(gates, bad_heads, assume_unique=True)
    return _merge_heads(gates, iupac_heads)


@partial(jax.jit, static_argnames=("k", "snv", "min_threshold", "chunk"))
def _gate_words_from_codes(packed, start_word, df: bloom.DeviceFilter, k: int,
                           snv: bool, min_threshold: int, chunk: int):
    """Gate bitmap (packed uint32) for heads [start, start + chunk) of the
    coded contig.  Same gate semantics as flag_chunk, minus window validity
    (handled host-side via the exception hint union)."""
    nw = chunk // 16 + _halo_words(k)
    words = jax.lax.dynamic_slice(packed, (start_word,), (nw,))
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, :]
    codes = ((words[:, None] >> shifts) & jnp.uint32(3)).astype(jnp.uint8)
    seqc = codes.reshape(-1)[: chunk + k - 1]
    fh, rh = nt.window_hashes_codes(seqc, k)
    can = nt.canonical(fh, rh)
    hashes = [can] if df.blocked else nt.extend(can, k, df.hash_num)
    if df.counting:
        count = df.count(hashes)
        present = count > 0
    else:
        present = df.contains(hashes)
        count = None
    gate = jnp.full(chunk, snv) | ~present
    if df.counting and min_threshold > 1:
        gate = gate | (count < np.uint8(min_threshold))
    lanes = jnp.arange(32, dtype=jnp.uint32)
    b = gate.reshape(-1, 32).astype(jnp.uint32)
    return (b << lanes[None, :]).sum(axis=1, dtype=jnp.uint32)


@partial(jax.jit, static_argnames=("k", "chunk"))
def _snv_cand_words_from_codes(packed, start_word, df: bloom.DeviceFilter,
                               k: int, chunk: int):
    """SNV candidate bitmap from coded bases (see snv_candidates_chunk for
    the algorithm; alternates here are always 'the 3 other bases' — coded
    positions are real ACGT, exception windows are re-added host-side)."""
    from ntedit_tpu.core import nthash_ref as _ref
    from ntedit_tpu.utils import u64

    nw = chunk // 16 + _halo_words(k)
    words = jax.lax.dynamic_slice(packed, (start_word,), (nw,))
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, :]
    codes = ((words[:, None] >> shifts) & jnp.uint32(3)).astype(jnp.uint8)
    seqc = codes.reshape(-1)[: chunk + k - 1]
    fh, rh = nt.window_hashes_codes(seqc, k)
    tail = seqc[k - 1 : k - 1 + chunk]
    fseed, cseed = nt.code_seeds(tail)
    csd = u64.srol_const(cseed, k - 1)
    fh_x = u64.xor(fh, fseed)
    rh_x = u64.xor(rh, csd)
    cand = jnp.zeros(chunk, dtype=bool)
    for ci, b in enumerate(b"ACGT"):
        sb = int(_ref.SEED_TAB[b])
        csb = int(_ref.srol_vec(
            np.asarray([_ref.SEED_TAB[b & nt.CP_OFF]]),
            np.asarray([(k - 1) % nt.SROL_PERIOD]))[0])
        fhb = (fh_x[0] ^ np.uint32(sb >> 32), fh_x[1] ^ np.uint32(sb & 0xFFFFFFFF))
        rhb = (rh_x[0] ^ np.uint32(csb >> 32), rh_x[1] ^ np.uint32(csb & 0xFFFFFFFF))
        can = nt.canonical(fhb, rhb)
        hashes = [can] if df.blocked else nt.extend(can, k, df.hash_num)
        present = df.contains(hashes)
        cand = cand | ((tail != np.uint8(ci)) & present)
    lanes = jnp.arange(32, dtype=jnp.uint32)
    bts = cand.reshape(-1, 32).astype(jnp.uint32)
    return (bts << lanes[None, :]).sum(axis=1, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# SNV batched site decision pass
#
# In SNV mode every head enters the fix path, so the "sparse repair"
# premise collapses and the per-site host state machine dominates
# (ntedit.cpp:1890-2062 with -s 1: confirmation scan + up to 4 alternate
# verify scans PER BASE).  But SNV sites are also independent unless an
# accepted edit lands within 2k (i = d = 0 — no indels, no rope changes,
# ntedit.cpp:2411-2413), so the whole per-site computation moves on
# device: for every CANDIDATE head (some alternate's changelast k-mer
# present — the provably-complete record/edit precondition) the kernel
# emits the confirmation check_there count, the 4 alternate pre-check
# bits, and the 4 alternate verify counts.  The native engine then
# consumes these rows verbatim at pristine sites (repair.cpp) — zero host
# probes — and re-evaluates live only windows near edits / exceptions /
# contig ends.  Bit-identity is by construction: the arbitration
# (shuffle_best, baseline, trial order) still runs in the engine; only
# the probe RESULTS are precomputed, and device probes are bit-identical
# to host probes.
#
# Hash algebra: a verify window at roll kk (head h+1+kk) contains the
# substituted tail position t = h+k-1 at window index i = k-2-kk, so its
# edited hash is the PRISTINE window hash XOR srol^{k-1-i}(seed(d)^seed(b))
# forward and XOR srol^{i}(cseed(d)^cseed(b)) reverse (srol is a bit
# permutation, hence XOR-linear) — nthash_ref.py window conventions.  The
# final roll kk = k-1 starts past t and probes the pristine window.
# ---------------------------------------------------------------------------

SNV_SITE_CAP = 1 << 16  # per-chunk candidate rows: SNV candidates are
# FPR-driven (~3x the filter FPR of heads, ~0.8% on a 0.91-occupancy
# blocked filter = ~34k per 2^22-head chunk); an overflow drops the rows
# AND the repair falls back to full live site evaluations, which are far
# slower — so this cap must clear realistic densities with margin
# (overflow stays graceful/exact)
SNV_WORD_CAP = 1 << 15  # nonzero cand words per chunk (same sizing logic)


@partial(jax.jit, static_argnames=("k", "jump", "chunk"))
def _snv_site_data_from_codes(packed, start_word, df: bloom.DeviceFilter,
                              k: int, jump: int, chunk: int):
    """One chunk of the SNV site-data pass.

    Returns (cand_words u32 [chunk/32], count i32, idx i32 [CAP],
    rows u8 [CAP, 6]) where rows[:, 0] = alternate pre-check bits (bit c =
    contains(changelast(head -> "ACGT"[c]))), rows[:, 1] = check_there,
    rows[:, 2 + c] = the verify count for alternate c.  Rows are computed
    for the first CAP candidates in head order; `count` > CAP flags
    overflow (host falls back to live probes for this chunk's sites)."""
    from ntedit_tpu.core import nthash_ref as _ref
    from ntedit_tpu.utils import u64

    nw = chunk // 16 + _halo_words_snv(k)
    words = jax.lax.dynamic_slice(packed, (start_word,), (nw,))
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, :]
    codes = ((words[:, None] >> shifts) & jnp.uint32(3)).astype(jnp.uint8)
    seqc = codes.reshape(-1)[: chunk + 2 * k - 1]
    fh, rh = nt.window_hashes_codes(seqc, k)  # heads [chunk + k]
    can = nt.canonical(fh, rh)
    hashes = [can] if df.blocked else nt.extend(can, k, df.hash_num)
    present = df.contains(hashes)             # pristine presence [chunk + k]

    tail = seqc[k - 1 : k - 1 + chunk]
    fseed, cseed = nt.code_seeds(tail)
    csd = u64.srol_const(cseed, k - 1)
    fh_head = (fh[0][:chunk], fh[1][:chunk])
    rh_head = (rh[0][:chunk], rh[1][:chunk])
    fh_x = u64.xor(fh_head, fseed)
    rh_x = u64.xor(rh_head, csd)
    pre = []
    for b in b"ACGT":
        sb = int(_ref.SEED_TAB[b])
        csb = int(_ref.srol(_ref.SEED_TAB[b & nt.CP_OFF], k - 1))
        fhb = (fh_x[0] ^ np.uint32(sb >> 32), fh_x[1] ^ np.uint32(sb & 0xFFFFFFFF))
        rhb = (rh_x[0] ^ np.uint32(csb >> 32), rh_x[1] ^ np.uint32(csb & 0xFFFFFFFF))
        cb = nt.canonical(fhb, rhb)
        hb = [cb] if df.blocked else nt.extend(cb, k, df.hash_num)
        pre.append(df.contains(hb))
    cand = jnp.zeros(chunk, dtype=bool)
    for ci in range(4):
        cand = cand | ((tail != np.uint8(ci)) & pre[ci])
    count = cand.sum(dtype=jnp.int32)
    idx = jnp.nonzero(cand, size=SNV_SITE_CAP, fill_value=chunk - 1)[0].astype(
        jnp.int32)

    strides = [kk for kk in range(k) if kk % jump == 0]
    sidx = jnp.stack([idx + 1 + kk for kk in strides])   # [S, CAP]
    check_there = present[sidx].sum(axis=0).astype(jnp.int32)

    tcode = tail[idx]
    fs_i, cs_i = nt.code_seeds(tcode)
    ver = []
    for ci, b in enumerate(b"ACGT"):
        sb = int(_ref.SEED_TAB[b])
        csb = int(_ref.SEED_TAB[b & nt.CP_OFF])
        dxf = (fs_i[0] ^ np.uint32(sb >> 32), fs_i[1] ^ np.uint32(sb & 0xFFFFFFFF))
        dxr = (cs_i[0] ^ np.uint32(csb >> 32), cs_i[1] ^ np.uint32(csb & 0xFFFFFFFF))
        cnt = jnp.zeros(idx.shape, jnp.int32)
        for si, kk in enumerate(strides):
            s = sidx[si]
            if kk == k - 1:
                # window starts past the substituted tail: pristine probe
                cnt = cnt + present[s].astype(jnp.int32)
                continue
            df_e = u64.srol_const(dxf, kk + 1)
            dr_e = u64.srol_const(dxr, k - 2 - kk)
            fw = (fh[0][s] ^ df_e[0], fh[1][s] ^ df_e[1])
            rv = (rh[0][s] ^ dr_e[0], rh[1][s] ^ dr_e[1])
            cb = nt.canonical(fw, rv)
            hb = [cb] if df.blocked else nt.extend(cb, k, df.hash_num)
            cnt = cnt + df.contains(hb).astype(jnp.int32)
        ver.append(cnt)

    prebits = jnp.zeros(idx.shape, jnp.int32)
    for ci in range(4):
        prebits = prebits | (pre[ci][idx].astype(jnp.int32) << ci)
    rows = jnp.stack(
        [prebits, jnp.minimum(check_there, 255)]
        + [jnp.minimum(v, 255) for v in ver], axis=1,
    ).astype(jnp.uint8)

    # candidate bitmap, compacted (nonzero words + values): candidates
    # are ~0.1-0.5% of heads, so this cuts the D2H readback ~30x
    lanes = jnp.arange(32, dtype=jnp.uint32)
    bts = cand.reshape(-1, 32).astype(jnp.uint32)
    cand_words = (bts << lanes[None, :]).sum(axis=1, dtype=jnp.uint32)
    nz = cand_words != 0
    nzw_count = nz.sum(dtype=jnp.int32)
    nzw_idx = jnp.nonzero(nz, size=SNV_WORD_CAP, fill_value=0)[0].astype(
        jnp.int32)
    nzw_val = jnp.where(
        jnp.arange(SNV_WORD_CAP) < nzw_count, cand_words[nzw_idx],
        np.uint32(0))
    return _fuse_site_out(nzw_count, nzw_idx, nzw_val, count, idx, rows)


# Polish analog of the SNV site pass.  The dense gate pass already finds
# the ~k gated heads around each error; the heavy per-site host work
# (confirmation scan + substitution pre-checks + verify scans, 25-30
# random DRAM probes per site) happens only at the FIRST gated head of
# each cluster — later heads are re-evaluated against edited content and
# are cheap single probes.  So this kernel emits, per cluster-start head:
# [flags, check_missing, verA..verT] rows the native engine consumes at
# pristine windows (bailing to live probes the moment an indel trial
# would trigger — rows shortcut pure-substitution decisions only, the
# overwhelmingly common case).  The gate bitmap itself is returned
# COMPACTED (nonzero words + values): gates cluster ~k consecutive bits,
# so the compact form is ~14x smaller than the bitmap.

POLISH_SITE_CAP = 1 << 14   # cluster-start rows per chunk (~5k seen at
# demo error rates on 2^22-head chunks; overflow -> rows skipped, exact)
GATE_WORD_CAP = 1 << 14     # nonzero cand words per chunk (SNV pass)


def _fuse_sites(site_count, idx, rows):
    """Fuse a chunk's per-site outputs into ONE int32 buffer (one
    readback per chunk instead of three).
    Layout (S = len(idx)): [0]=site_count [1:1+S]=site_idx
    [1+S:1+3S]=rows (u8 [S,8] bitcast)."""
    rows8 = jnp.concatenate(
        [rows, jnp.zeros((rows.shape[0], 2), jnp.uint8)], axis=1)
    return jnp.concatenate([
        site_count[None].astype(jnp.int32),
        idx,
        jax.lax.bitcast_convert_type(
            rows8.reshape(-1, 4), jnp.int32).reshape(-1),
    ])


def _split_sites(buf: np.ndarray, S: int):
    """Inverse of _fuse_sites on the host numpy buffer."""
    site_count = int(buf[0])
    idx = buf[1 : 1 + S]
    rows = buf[1 + S :].view(np.uint8).reshape(S, 8)[:, :6]
    return site_count, idx, rows


def _fuse_site_out(nzw_count, nzw_idx, nzw_val, site_count, idx, rows):
    """SNV variant: compact candidate words + sites in one buffer.
    Layout (W = len(nzw_idx), S = len(idx)):
    [0]=nzw_count [1]=site_count [2:2+W]=nzw_idx [2+W:2+2W]=nzw_val
    [2+2W:2+2W+S]=site_idx [2+2W+S:2+2W+3S]=rows (u8 [S,8] bitcast)."""
    rows8 = jnp.concatenate(
        [rows, jnp.zeros((rows.shape[0], 2), jnp.uint8)], axis=1)
    return jnp.concatenate([
        jnp.stack([nzw_count, site_count]),
        nzw_idx,
        jax.lax.bitcast_convert_type(nzw_val, jnp.int32),
        idx,
        jax.lax.bitcast_convert_type(
            rows8.reshape(-1, 4), jnp.int32).reshape(-1),
    ])


def _split_site_out(buf: np.ndarray, W: int, S: int):
    """Inverse of _fuse_site_out on the host numpy buffer."""
    nzw_count = int(buf[0])
    site_count = int(buf[1])
    nzw_idx = buf[2 : 2 + W]
    nzw_val = buf[2 + W : 2 + 2 * W].view(np.uint32)
    idx = buf[2 + 2 * W : 2 + 2 * W + S]
    rows = buf[2 + 2 * W + S :].view(np.uint8).reshape(S, 8)[:, :6]
    return nzw_count, nzw_idx, nzw_val, site_count, idx, rows


def _positions_from_compact(widx: np.ndarray, wval: np.ndarray,
                            n: int) -> np.ndarray:
    """(nonzero word indices, word values) -> sorted bit positions < n."""
    if not len(widx):
        return np.zeros(0, dtype=np.int64)
    bits = np.unpackbits(wval.view(np.uint8), bitorder="little").reshape(-1, 32)
    r, c = np.nonzero(bits)
    g = widx.astype(np.int64)[r] * 32 + c
    return g[g < n]


@partial(jax.jit, static_argnames=("k", "jump", "chunk"))
def _polish_site_data_from_codes(packed, start_word, df: bloom.DeviceFilter,
                                 k: int, jump: int, chunk: int):
    """One chunk of the polish site-data pass (non-counting filters).

    Returns (nzw_idx i32 [WCAP], nzw_val u32 [WCAP], nzw_count i32,
    site_idx i32 [SCAP], rows u8 [SCAP, 6], site_count i32) where rows =
    [pre bits, check_missing, verA, verC, verG, verT] for cluster-start
    heads (gated head whose previous head is not gated)."""
    from ntedit_tpu.core import nthash_ref as _ref
    from ntedit_tpu.utils import u64

    nw = chunk // 16 + _halo_words_snv(k)
    words = jax.lax.dynamic_slice(packed, (start_word,), (nw,))
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, :]
    codes = ((words[:, None] >> shifts) & jnp.uint32(3)).astype(jnp.uint8)
    seqc = codes.reshape(-1)[: chunk + 2 * k - 1]
    fh, rh = nt.window_hashes_codes(seqc, k)  # heads [chunk + k]
    can = nt.canonical(fh, rh)
    hashes = [can] if df.blocked else nt.extend(can, k, df.hash_num)
    present = df.contains(hashes)             # pristine presence [chunk + k]

    gate = ~present[:chunk]
    lanes = jnp.arange(32, dtype=jnp.uint32)
    gw = (gate.reshape(-1, 32).astype(jnp.uint32)
          << lanes[None, :]).sum(axis=1, dtype=jnp.uint32)
    # the gate bitmap ships whole: at realistic error rates ~3% of heads
    # gate (each error gates ~k windows), so a capped nonzero-word
    # compaction overflows while the bitmap is already only chunk/8 bytes

    prev_present = jnp.concatenate(
        [jnp.ones(1, dtype=bool), present[: chunk - 1]])
    cs = gate & prev_present  # cluster starts (chunk head 0: emit, safe)
    site_count = cs.sum(dtype=jnp.int32)
    idx = jnp.nonzero(cs, size=POLISH_SITE_CAP, fill_value=chunk - 1)[0].astype(
        jnp.int32)

    strides = [kk for kk in range(k) if kk % jump == 0]
    sidx = jnp.stack([idx + 1 + kk for kk in strides])   # [S, CAP]
    check_missing = (~present[sidx]).sum(axis=0).astype(jnp.int32)

    # sparse changelast pre-checks + verify counts at the site heads
    tail = seqc[k - 1 : k - 1 + chunk]
    tcode = tail[idx]
    fs_i, cs_i = nt.code_seeds(tcode)
    fh_i = (fh[0][idx], fh[1][idx])
    rh_i = (rh[0][idx], rh[1][idx])
    csd_i = u64.srol_const(cs_i, k - 1)
    fh_x = u64.xor(fh_i, fs_i)
    rh_x = u64.xor(rh_i, csd_i)
    pre_bits = jnp.zeros(idx.shape, jnp.int32)
    ver = []
    for ci, b in enumerate(b"ACGT"):
        sb = int(_ref.SEED_TAB[b])
        csb_k1 = int(_ref.srol(_ref.SEED_TAB[b & nt.CP_OFF], k - 1))
        fhb = (fh_x[0] ^ np.uint32(sb >> 32), fh_x[1] ^ np.uint32(sb & 0xFFFFFFFF))
        rhb = (rh_x[0] ^ np.uint32(csb_k1 >> 32),
               rh_x[1] ^ np.uint32(csb_k1 & 0xFFFFFFFF))
        cb = nt.canonical(fhb, rhb)
        hb = [cb] if df.blocked else nt.extend(cb, k, df.hash_num)
        pre_bits = pre_bits | (df.contains(hb).astype(jnp.int32) << ci)
        csb = int(_ref.SEED_TAB[b & nt.CP_OFF])
        dxf = (fs_i[0] ^ np.uint32(sb >> 32), fs_i[1] ^ np.uint32(sb & 0xFFFFFFFF))
        dxr = (cs_i[0] ^ np.uint32(csb >> 32), cs_i[1] ^ np.uint32(csb & 0xFFFFFFFF))
        cnt = jnp.zeros(idx.shape, jnp.int32)
        for si, kk in enumerate(strides):
            s = sidx[si]
            if kk == k - 1:
                cnt = cnt + present[s].astype(jnp.int32)
                continue
            df_e = u64.srol_const(dxf, kk + 1)
            dr_e = u64.srol_const(dxr, k - 2 - kk)
            fw = (fh[0][s] ^ df_e[0], fh[1][s] ^ df_e[1])
            rv = (rh[0][s] ^ dr_e[0], rh[1][s] ^ dr_e[1])
            cb2 = nt.canonical(fw, rv)
            hb2 = [cb2] if df.blocked else nt.extend(cb2, k, df.hash_num)
            cnt = cnt + df.contains(hb2).astype(jnp.int32)
        ver.append(cnt)

    rows = jnp.stack(
        [pre_bits, jnp.minimum(check_missing, 255)]
        + [jnp.minimum(v, 255) for v in ver], axis=1,
    ).astype(jnp.uint8)
    return gw, _fuse_sites(site_count, idx, rows)


def iter_polish_site_chunks(
    seq: np.ndarray, df: bloom.DeviceFilter, jump: int,
    chunk: int = DEFAULT_CHUNK,
):
    """Streamed polish dense pass with per-site decision rows: yields
    (frontier, gates, rows) with rows uint8 [len(gates), 6] parallel to
    gates — flags bit0 marks engine-consumable rows (cluster-start head,
    full 2k scan in-contig, no exception bytes; flag.snv_site_data
    validity rules).  Heads without rows carry zero flags and are probed
    live.  All chunk programs dispatch up front (async); readbacks drain
    in order so repair overlaps later chunks' compute."""
    k = df.k
    L = len(seq)
    n = L - k + 1
    if n <= 0:
        return
    chunk = _effective_chunk(n, chunk)
    packed, exc = packed_device(seq, n, k, chunk,
                                halo_words=_halo_words_snv(k))
    outs = []
    for start in range(0, n, chunk):
        outs.append(_polish_site_data_from_codes(
            packed, np.int32(start // 16), df, k, jump, chunk))
    for gw, sbuf in outs:
        for arr in (gw, sbuf):
            try:
                arr.copy_to_host_async()
            except AttributeError:
                pass
    iupac_heads, bad_heads = _exception_hints(seq, exc, n, k)
    for i, (gw, sbuf) in enumerate(outs):
        start = i * chunk
        end = min(start + chunk, n)
        if start >= n:
            break
        g = packed_to_positions(np.asarray(gw), end - start) + start
        sc, idx, rows = _split_sites(np.asarray(sbuf), POLISH_SITE_CAP)
        if bad_heads.size:
            lo, hi = np.searchsorted(bad_heads, (start, end))
            g = np.setdiff1d(g, bad_heads[lo:hi], assume_unique=True)
        if iupac_heads.size:
            lo, hi = np.searchsorted(iupac_heads, (start, end))
            g = _merge_heads(g, iupac_heads[lo:hi])
        rows_full = np.zeros((len(g), 6), dtype=np.uint8)
        # flags bit 5 = "device-exact gate": the head came from the
        # device's compact gate words (bit-identical probes), not from
        # the exception-patched superset — the engine may skip its live
        # gate re-probe at pristine windows (repair.cpp hint trust)
        if len(g):
            exact = np.ones(len(g), dtype=bool)
            if iupac_heads.size:
                lo, hi = np.searchsorted(iupac_heads, (start, end))
                if hi > lo:
                    exact &= ~np.isin(g, iupac_heads[lo:hi],
                                      assume_unique=True)
            rows_full[exact, 0] |= 32
        if sc <= POLISH_SITE_CAP and len(g):
            sp = idx[:sc].astype(np.int64) + start
            sr = rows[:sc]
            keep = sp < n
            sp, sr = sp[keep], sr[keep]
            valid = sp <= (n - k - 1)
            if len(exc):
                lo = np.searchsorted(exc, sp)
                hi = np.searchsorted(exc, sp + 2 * k - 1)
                valid &= lo == hi
            slot = np.searchsorted(g, sp)
            ok = slot < len(g)
            ok &= g[np.minimum(slot, len(g) - 1)] == sp
            ok &= valid
            tgt = slot[ok]
            rows_full[tgt, 1:] = sr[ok, 1:]
            rows_full[tgt, 0] |= 1 | (sr[ok, 0] << 1)  # keep bit 5
        yield end, g, rows_full


def snv_site_data(
    seq: np.ndarray, df: bloom.DeviceFilter, jump: int,
    chunk: int = DEFAULT_CHUNK,
):
    """Candidate positions + per-site decision rows for the SNV fast path.

    Returns (cand_positions int64 [G], rows uint8 [G, 6]) parallel arrays:
    rows[:, 0] = flags (bit0 = row valid; bits 1-4 = alternate pre-check
    bits for A/C/G/T), rows[:, 1] = check_there, rows[:, 2+c] = verify
    counts.  A row is valid only when the engine may consume it instead
    of probing: the full 2k-window scan fits inside the contig
    (h <= n-k-1) and touches no exception (non-ACGT) byte.  Invalid rows
    (zero flags) make the engine probe live — superset-safe.  Caller
    guarantees Polisher._snv_fast_eligible (non-counting filter, no
    reject BF, mode != 2, mask off)."""
    k = df.k
    L = len(seq)
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64), np.zeros((0, 6), dtype=np.uint8)
    chunk = _effective_chunk(n, chunk)
    packed, exc = packed_device(seq, n, k, chunk,
                                halo_words=_halo_words_snv(k))
    outs = []
    for start in range(0, n, chunk):
        outs.append(_snv_site_data_from_codes(
            packed, np.int32(start // 16), df, k, jump, chunk))
    for out in outs:
        try:
            out.copy_to_host_async()
        except AttributeError:
            pass
    iupac_heads, bad_heads = _exception_hints(seq, exc, n, k)
    positions = []
    site_pos = []
    site_rows = []
    for i, out in enumerate(outs):
        start = i * chunk
        end = min(n, start + chunk)
        wc, nzw_idx, nzw_val, c, idx, rows = _split_site_out(
            np.asarray(out), SNV_WORD_CAP, SNV_SITE_CAP)
        if wc <= SNV_WORD_CAP:
            g = _positions_from_compact(
                nzw_idx[:wc], nzw_val[:wc], end - start) + start
        else:  # pathological density: full bitmap for this chunk
            w = np.asarray(_snv_cand_words_from_codes(
                packed, np.int32(start // 16), df, k, chunk))
            g = packed_to_positions(w, end - start) + start
        positions.append(g)
        if c <= SNV_SITE_CAP:
            p = idx[:c].astype(np.int64) + start
            keep = p < n
            site_pos.append(p[keep])
            site_rows.append(rows[:c][keep])
    cand = (np.concatenate(positions) if positions
            else np.zeros(0, dtype=np.int64))
    cand = _apply_exceptions(cand, iupac_heads, bad_heads)
    rows_full = np.zeros((len(cand), 6), dtype=np.uint8)
    if site_pos and len(cand):
        sp = np.concatenate(site_pos)
        sr = (np.concatenate(site_rows) if site_rows
              else np.zeros((0, 6), np.uint8))
        valid = sp <= (n - k - 1)  # full scan fits before the contig end
        if len(exc):
            lo = np.searchsorted(exc, sp)
            hi = np.searchsorted(exc, sp + 2 * k - 1)
            valid &= lo == hi     # no exception byte inside [h, h + 2k - 1)
        slot = np.searchsorted(cand, sp)
        ok = (slot < len(cand))
        ok &= cand[np.minimum(slot, len(cand) - 1)] == sp
        ok &= valid
        tgt = slot[ok]
        rows_full[tgt, 1:] = sr[ok, 1:]
        rows_full[tgt, 0] = 1 | (sr[ok, 0] << 1)
    return cand, rows_full


@partial(jax.jit, static_argnames=("k", "chunk"))
def _polish_cand_planes_from_codes(packed, start_word, df: bloom.DeviceFilter,
                                   k: int, chunk: int):
    """Per-base changelast-presence planes for one chunk: (4, chunk//32)
    uint32 — plane c bit at head h == df.contains(changelast(window at h
    -> base "ACGT"[c])) on the draft codes.  The repair engine consults
    these as its substitution first-level probe at pristine windows
    (repair.cpp fix_site) — same changelast XOR algebra
    as _snv_cand_words_from_codes, kept per-base instead of OR-folded."""
    from ntedit_tpu.core import nthash_ref as _ref
    from ntedit_tpu.utils import u64

    nw = chunk // 16 + _halo_words(k)
    words = jax.lax.dynamic_slice(packed, (start_word,), (nw,))
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, :]
    codes = ((words[:, None] >> shifts) & jnp.uint32(3)).astype(jnp.uint8)
    seqc = codes.reshape(-1)[: chunk + k - 1]
    fh, rh = nt.window_hashes_codes(seqc, k)
    tail = seqc[k - 1 : k - 1 + chunk]
    fseed, cseed = nt.code_seeds(tail)
    csd = u64.srol_const(cseed, k - 1)
    fh_x = u64.xor(fh, fseed)
    rh_x = u64.xor(rh, csd)
    lanes = jnp.arange(32, dtype=jnp.uint32)
    planes = []
    for b in b"ACGT":
        sb = int(_ref.SEED_TAB[b])
        csb = int(_ref.srol_vec(
            np.asarray([_ref.SEED_TAB[b & nt.CP_OFF]]),
            np.asarray([(k - 1) % nt.SROL_PERIOD]))[0])
        fhb = (fh_x[0] ^ np.uint32(sb >> 32), fh_x[1] ^ np.uint32(sb & 0xFFFFFFFF))
        rhb = (rh_x[0] ^ np.uint32(csb >> 32), rh_x[1] ^ np.uint32(csb & 0xFFFFFFFF))
        can = nt.canonical(fhb, rhb)
        hashes = [can] if df.blocked else nt.extend(can, k, df.hash_num)
        present = df.contains(hashes).reshape(-1, 32).astype(jnp.uint32)
        planes.append((present << lanes[None, :]).sum(axis=1, dtype=jnp.uint32))
    return jnp.stack(planes)


@partial(jax.jit, static_argnames=())
def _gather_cand_masks(planes, gpos):
    """planes (4, NW) uint32 + head positions (G,) int32 -> uint8 masks."""
    w = (gpos >> 5).astype(jnp.int32)
    s = (gpos & 31).astype(jnp.uint32)
    m = jnp.zeros(gpos.shape, jnp.uint32)
    for ci in range(4):
        m = m | (((planes[ci][w] >> s) & jnp.uint32(1)) << np.uint32(ci))
    return m.astype(jnp.uint8)


def polish_candidate_masks(
    seq: np.ndarray, df: bloom.DeviceFilter, gates: np.ndarray,
    chunk: int = DEFAULT_CHUNK,
) -> Optional[np.ndarray]:
    """Device pre-verification of polish substitution candidates.

    Returns uint8 masks parallel to ``gates`` (bit c == the draft-window
    contains(changelast -> "ACGT"[c]) result; 0xFF = exception window,
    probe live), or None when the hint would be unsound (counting
    filter / reject BF configs are refused by the caller).  The planes
    stay on device; only ~1 byte per GATE crosses back (gates are
    0.1-3% of heads), so the added transfer is noise next to the gate
    bitmap itself."""
    k = df.k
    L = len(seq)
    n = L - k + 1
    if n <= 0 or len(gates) == 0:
        return np.zeros(len(gates), dtype=np.uint8)
    chunk = _effective_chunk(n, chunk)
    packed, exc = packed_device(seq, n, k, chunk)
    outs = []
    for start in range(0, n, chunk):
        outs.append(_polish_cand_planes_from_codes(
            packed, np.int32(start // 16), df, k, chunk))
    planes = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)
    g = np.ascontiguousarray(gates, dtype=np.int64)
    if len(g) and int(g[-1]) >= (1 << 31):
        # contigs past 2^31 bases would wrap the int32 gather below and
        # read masks from wrong plane words — fall back to live probes
        return None
    # pad to pow2 buckets so the gather program compiles a bounded set
    G = 1 << max(5, int(np.ceil(np.log2(max(1, len(g))))))
    gpad = np.zeros(G, dtype=np.int32)
    gpad[: len(g)] = g.astype(np.int32)
    masks = np.array(_gather_cand_masks(planes, jnp.asarray(gpad)))[: len(g)]
    iupac_heads, bad_heads = _exception_hints(seq, exc, n, k)
    if len(iupac_heads) or len(bad_heads):
        bad = np.union1d(np.asarray(iupac_heads), np.asarray(bad_heads))
        masks[np.isin(g, bad)] = 0xFF
    return masks


def packed_to_positions(words: np.ndarray, n: int) -> np.ndarray:
    """Little-endian packed gate words -> sorted gate head positions < n.
    Gates are sparse (~0.1-3% of heads): touch only the nonzero words."""
    nzw = np.nonzero(words)[0]
    if not len(nzw):
        return np.zeros(0, dtype=np.int64)
    sub = np.unpackbits(
        words[nzw].view(np.uint8), bitorder="little"
    ).reshape(-1, 32)
    rows, cols = np.nonzero(sub)
    g = nzw[rows].astype(np.int64) * 32 + cols
    return g[g < n]


def flag_contig_gates(
    seq: np.ndarray,
    df: bloom.DeviceFilter,
    snv: bool = False,
    min_threshold: int = 1,
    chunk: int = DEFAULT_CHUNK,
) -> np.ndarray:
    """Gate head positions for one contig.

    Fixed-shape chunk program over ONE up-front packed-code upload (see
    the packed-code section above): any contig length reuses a single
    compiled executable (a tile-count-specialized program would recompile
    per contig length).  All
    chunk dispatches are issued asynchronously, concatenated on device,
    and read back once."""
    k = df.k
    L = len(seq)
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    chunk = _effective_chunk(n, chunk)
    packed, exc = packed_device(seq, n, k, chunk)
    outs = []
    for start in range(0, n, chunk):
        outs.append(_gate_words_from_codes(
            packed, np.int32(start // 16), df, k, snv, min_threshold, chunk))
    words_dev = outs[0] if len(outs) == 1 else jnp.concatenate(outs)
    words = np.asarray(words_dev)
    iupac_heads, bad_heads = _exception_hints(seq, exc, n, k)
    return _apply_exceptions(packed_to_positions(words, n), iupac_heads, bad_heads)


@partial(jax.jit, static_argnames=("k",))
def snv_candidates_chunk(seq, df: bloom.DeviceFilter, k: int):
    """SNV candidate bitmap for one chunk, packed to uint32 words.

    SNV mode re-tests every position, but a position can only produce a
    record (or an edit) when at least one alternate base passes the
    pre-check — the substituted k-mer itself present and solid
    (ntedit.cpp:1923-1928; with a plain filter and no reject BF, solid is
    always true).  That pre-check is a last-base-replacement rehash
    (NTMC64_changelast, ntedit.cpp:434-452) — pure elementwise XOR algebra
    — so it runs densely on device for all four bases at once; positions
    with no passing alternate are provably no-ops and the host engine
    skips them via the hint.  Caller guarantees: non-counting filter, no
    reject BF, mode != 2, mask off (those paths fall back to the full
    scan)."""
    from ntedit_tpu.utils import u64

    fh, rh = nt.window_hashes.__wrapped__(seq, k)
    n = seq.shape[0] - k + 1
    tail = seq[k - 1 : k - 1 + n]
    # changelast removes the draft tail seed and inserts the alternate's:
    # forward: fh ^ seed(draft) ^ seed(alt);
    # reverse: rh ^ srol^{k-1}(cseed(draft)) ^ srol^{k-1}(cseed(alt))
    sd = nt.seed_of(tail)
    csd = u64.srol_const(nt.cseed_of(tail), k - 1)
    fh_x = u64.xor(fh, sd)
    rh_x = u64.xor(rh, csd)
    fold = tail.astype(jnp.int32) & 0xDF
    is_acgt = (
        (fold == ord("A")) | (fold == ord("C"))
        | (fold == ord("G")) | (fold == ord("T"))
    )
    cand = jnp.zeros(n, dtype=bool)
    from ntedit_tpu.core import nthash_ref as _ref

    for b in b"ACGT":
        sb = int(_ref.SEED_TAB[b])
        csb = int(_ref.srol_vec(
            np.asarray([_ref.SEED_TAB[b & nt.CP_OFF]]),
            np.asarray([(k - 1) % nt.SROL_PERIOD]))[0])
        fhb = (fh_x[0] ^ np.uint32(sb >> 32), fh_x[1] ^ np.uint32(sb & 0xFFFFFFFF))
        rhb = (rh_x[0] ^ np.uint32(csb >> 32), rh_x[1] ^ np.uint32(csb & 0xFFFFFFFF))
        can = nt.canonical(fhb, rhb)
        hashes = [can] if df.blocked else nt.extend(can, k, df.hash_num)
        present = df.contains(hashes)
        # SNV alternates: ACGT draft -> the 3 other bases; accepted IUPAC
        # draft -> all four (snv_bases_array, ntedit.cpp:190-199)
        allowed = (~is_acgt) | (fold != b)
        cand = cand | (allowed & present)
    valid = _window_all(_accepted(seq), k, n)
    g = cand & valid
    lanes = jnp.arange(32, dtype=jnp.uint32)
    bts = g.reshape(-1, 32).astype(jnp.uint32)
    return (bts << lanes[None, :]).sum(axis=1, dtype=jnp.uint32)


@partial(jax.jit, static_argnames=("k",))
def polish_cand_planes_chunk(seq, df: bloom.DeviceFilter, k: int):
    """Sharded-path variant of _polish_cand_planes_from_codes over raw
    draft bytes: (5, n/32) uint32 — planes 0-3 are the per-base
    changelast presence bits, plane 4 is a strict-ACGT window-validity
    bit (0 -> the host must treat the head's mask as 0xFF/no-info and
    probe live).  Same changelast XOR algebra as snv_candidates_chunk."""
    from ntedit_tpu.core import nthash_ref as _ref
    from ntedit_tpu.utils import u64

    fh, rh = nt.window_hashes.__wrapped__(seq, k)
    n = seq.shape[0] - k + 1
    tail = seq[k - 1 : k - 1 + n]
    sd = nt.seed_of(tail)
    csd = u64.srol_const(nt.cseed_of(tail), k - 1)
    fh_x = u64.xor(fh, sd)
    rh_x = u64.xor(rh, csd)
    lanes = jnp.arange(32, dtype=jnp.uint32)
    planes = []
    for b in b"ACGT":
        sb = int(_ref.SEED_TAB[b])
        csb = int(_ref.srol_vec(
            np.asarray([_ref.SEED_TAB[b & nt.CP_OFF]]),
            np.asarray([(k - 1) % nt.SROL_PERIOD]))[0])
        fhb = (fh_x[0] ^ np.uint32(sb >> 32), fh_x[1] ^ np.uint32(sb & 0xFFFFFFFF))
        rhb = (rh_x[0] ^ np.uint32(csb >> 32), rh_x[1] ^ np.uint32(csb & 0xFFFFFFFF))
        can = nt.canonical(fhb, rhb)
        hashes = [can] if df.blocked else nt.extend(can, k, df.hash_num)
        present = df.contains(hashes).reshape(-1, 32).astype(jnp.uint32)
        planes.append((present << lanes[None, :]).sum(axis=1, dtype=jnp.uint32))
    fold = seq.astype(jnp.int32) & 0xDF
    acgt = (
        (fold == ord("A")) | (fold == ord("C"))
        | (fold == ord("G")) | (fold == ord("T"))
    )
    valid = _window_all(acgt, k, n).reshape(-1, 32).astype(jnp.uint32)
    planes.append((valid << lanes[None, :]).sum(axis=1, dtype=jnp.uint32))
    return jnp.stack(planes)


def cand_masks_from_planes(planes: np.ndarray, gates: np.ndarray) -> np.ndarray:
    """Host-side gather: (5, NW) candidate/validity plane words (already
    concatenated across tiles) + gate head positions -> uint8 masks
    parallel to ``gates`` (0xFF where plane 4 says no-info)."""
    g = np.ascontiguousarray(gates, dtype=np.int64)
    w = g >> 5
    s = (g & 31).astype(np.uint32)
    mask = np.zeros(len(g), dtype=np.uint8)
    for ci in range(4):
        mask |= (((planes[ci][w] >> s) & 1) << ci).astype(np.uint8)
    invalid = ((planes[4][w] >> s) & 1) == 0
    mask[invalid] = 0xFF
    return mask


def snv_candidate_positions(
    seq: np.ndarray, df: bloom.DeviceFilter, chunk: int = DEFAULT_CHUNK
) -> np.ndarray:
    """Candidate head positions for the SNV fast path (see
    snv_candidates_chunk).  Same packed-code async driver as the polish
    gate pass; exception windows (non-ACGT draft bytes) are patched
    host-side per isAcceptedBase semantics (_exception_hints) — the
    engine re-tests every hinted head exactly."""
    k = df.k
    L = len(seq)
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    chunk = _effective_chunk(n, chunk)
    packed, exc = packed_device(seq, n, k, chunk)
    outs = []
    for start in range(0, n, chunk):
        outs.append(_snv_cand_words_from_codes(
            packed, np.int32(start // 16), df, k, chunk))
    words_dev = outs[0] if len(outs) == 1 else jnp.concatenate(outs)
    iupac_heads, bad_heads = _exception_hints(seq, exc, n, k)
    return _apply_exceptions(
        packed_to_positions(np.asarray(words_dev), n), iupac_heads, bad_heads
    )


def iter_gate_chunks(
    seq: np.ndarray,
    df: bloom.DeviceFilter,
    snv: bool = False,
    min_threshold: int = 1,
    chunk: int = DEFAULT_CHUNK,
):
    """Stream gate positions per chunk: yields (frontier, gates) where
    ``gates`` are ABSOLUTE head positions < ``frontier`` and every head
    < frontier has now been reported.

    Every chunk's device program is dispatched up front (async); readbacks
    then drain in order, so consumers overlap host work (sparse repair)
    with the in-flight device computation of later chunks."""
    k = df.k
    L = len(seq)
    n = L - k + 1
    if n <= 0:
        return
    chunk = _effective_chunk(n, chunk)
    packed, exc = packed_device(seq, n, k, chunk)
    iupac_heads, bad_heads = _exception_hints(seq, exc, n, k)
    outs = []
    for start in range(0, n, chunk):
        outs.append((start, _gate_words_from_codes(
            packed, np.int32(start // 16), df, k, snv, min_threshold, chunk)))
    for _start, out in outs:
        # queue all device->host copies up front: readbacks then stream
        # behind the compute instead of paying one sync round trip each
        try:
            out.copy_to_host_async()
        except AttributeError:
            pass
    for start, out in outs:
        words = np.asarray(out)
        g = packed_to_positions(words, min(chunk, n - start)) + start
        end = min(start + chunk, n)
        if bad_heads.size:
            lo, hi = np.searchsorted(bad_heads, (start, end))
            g = np.setdiff1d(g, bad_heads[lo:hi], assume_unique=True)
        if iupac_heads.size:
            lo, hi = np.searchsorted(iupac_heads, (start, end))
            g = _merge_heads(g, iupac_heads[lo:hi])
        yield end, g


def flag_contig(
    seq: np.ndarray,
    df: bloom.DeviceFilter,
    snv: bool = False,
    min_threshold: int = 1,
    chunk: int = DEFAULT_CHUNK,
):
    """Host orchestration: chunked dense pass over one contig.

    Returns numpy (gate, present, count, valid) of length L - k + 1.
    """
    k = df.k
    L = len(seq)
    n = L - k + 1
    if n <= 0:
        z = np.zeros(0, dtype=bool)
        return z, z, np.zeros(0, np.uint8), z
    chunk = _effective_chunk(n, chunk)
    gates, presents, counts, valids = [], [], [], []
    # pad the tail so every chunk has identical shape (one compile)
    pad_total = (-n) % chunk
    padded = np.concatenate([seq, np.zeros(pad_total, dtype=np.uint8)])
    for start in range(0, n, chunk):
        piece = jnp.asarray(padded[start : start + chunk + k - 1])
        g, p, c, v = flag_chunk(piece, df, k, snv, min_threshold)
        gates.append(np.asarray(g))
        presents.append(np.asarray(p))
        counts.append(np.asarray(c))
        valids.append(np.asarray(v))
    cat = lambda xs: np.concatenate(xs)[:n]
    return cat(gates), cat(presents), cat(counts), cat(valids)
