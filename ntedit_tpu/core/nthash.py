"""ntHash2 on device: vectorized JAX implementation over uint32-pair u64 lanes.

Two computation styles, both bit-identical to ntedit_tpu.core.nthash_ref
(property-tested):

1. ``window_hashes(seq, k)`` — the *dense pass*: canonical multi-hashes of
   every k-mer window of a sequence tile, computed with a doubling
   sliding-window XOR instead of a sequential roll:

       fh(h) = srol^{h+k-1}( XOR_{t=h..h+k-1} srol^{-t}(seed(s_t)) ),
       rh(h) = srol^{-h}(    XOR_{t=h..h+k-1} srol^{t}(cseed(s_t)) ).

   The width-k window XOR is built from O(log k) elementwise shifted-XOR
   passes (D_j[i] = XOR of terms [i, i+2^j); combine the binary digits of
   k).  This replaces the reference's per-base O(1) roll (a loop-carried
   dependency, /root/reference/ntedit.cpp:1216-1247) with a constant-depth
   data-parallel form of elementwise work that XLA fuses — and,
   unlike a full prefix-XOR ``associative_scan``, it lowers to a tiny XLA
   graph (compile time matters: tiles are large and shapes vary).

2. ``windows_direct(buf, k, offsets)`` — the *repair pass* primitive:
   hashes of explicit small windows of an edit buffer, computed by direct
   XOR of per-position rotated seed table lookups.  Used inside the batched
   edit state machine where the sequence mutates between probes.

Multi-hash extension (``extend``) follows ntHash's published NTM64 mixing;
see nthash_ref.extend_hashes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ntedit_tpu.core import nthash_ref as ref
from ntedit_tpu.utils import u64

SROL_PERIOD = ref.SROL_PERIOD
CP_OFF = ref.CP_OFF


def _tab_pair(tab_u64: np.ndarray):
    # numpy on purpose: captured tables embed into the lowered program as
    # inline constants; device-resident (jnp) constants would be pulled
    # back host-side during every lowering
    return (
        (tab_u64 >> np.uint64(32)).astype(np.uint32),
        (tab_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )


# [256] forward seed table and complement-aliased table (SEED_TAB[c & 7]).
SEED_TAB = _tab_pair(ref.SEED_TAB)
CSEED_TAB = _tab_pair(ref.SEED_TAB[np.arange(256) & CP_OFF])

_MULTISEED = ref.MULTISEED
_MULTISHIFT = int(ref.MULTISHIFT)


def _sel4(key, pairs, default=np.uint32(0)):
    """where-chain select of u64-pair constants by per-element key.

    ``pairs`` is [(key_value, np.uint64 constant), ...].  Pure arithmetic:
    four compares + selects fuse into the surrounding elementwise work,
    where a [256]-table jnp gather per position would be one more
    device-memory gather."""
    hi = jnp.full(key.shape, default)
    lo = jnp.full(key.shape, default)
    for kv, const in pairs:
        c = int(const)
        hi = jnp.where(key == kv, np.uint32(c >> 32), hi)
        lo = jnp.where(key == kv, np.uint32(c & 0xFFFFFFFF), lo)
    return hi, lo


def seed_of(seq):
    """ASCII bytes [..] -> forward seeds as u64 pair.

    Exact SEED_TAB semantics: nonzero only for ACGT/acgt (case-folded via
    & 0xDF), zero for every other byte."""
    fold = jnp.asarray(seq, jnp.int32) & 0xDF
    return _sel4(fold, [
        (ord("A"), ref.SEED_A), (ord("C"), ref.SEED_C),
        (ord("G"), ref.SEED_G), (ord("T"), ref.SEED_T),
    ])


def cseed_of(seq):
    """Complement seeds: SEED_TAB[c & 7] for ALL bytes (including btllib's
    quirky IUPAC aliasing, e.g. 'Y' & 7 == 1 -> SEED_T) — the & 7 slots are
    1->T, 3->G, 4->A, 7->C, rest zero."""
    m = jnp.asarray(seq, jnp.int32) & 7
    return _sel4(m, [
        (1, ref.SEED_T), (3, ref.SEED_G), (4, ref.SEED_A), (7, ref.SEED_C),
    ])


def canonical(fh, rh):
    return u64.min_(fh, rh)


def extend(base, k: int, m: int):
    """[...]-shaped canonical hash pair -> list of m hash pairs.

    h[0] = base; h[i] = mix(base * (i ^ k*MULTISEED)) per ntHash NTM64.
    """
    out = [base]
    for i in range(1, m):
        mult = (i ^ (k * int(_MULTISEED))) & 0xFFFFFFFFFFFFFFFF
        mult_pair = (
            jnp.full_like(base[0], np.uint32(mult >> 32)),
            jnp.full_like(base[1], np.uint32(mult & 0xFFFFFFFF)),
        )
        t = u64.mul_lo(base, mult_pair)
        t = u64.xor(t, u64.shr(t, _MULTISHIFT))
        out.append(t)
    return out


def _window_xor(pair, k: int, n: int):
    """XOR over every width-k window of a u32-pair array [L] -> [n].

    Doubling construction: D_1 = terms; D_2w[i] = D_w[i] ^ D_w[i+w]
    (length shrinks by w), then the window XOR combines the binary digits
    of k at staggered offsets.  O(log k) elementwise passes, constant
    graph depth — no scan."""
    levels = {1: pair}
    w = 1
    while 2 * w <= k:
        hi, lo = levels[w]
        levels[2 * w] = (hi[: -w or None] ^ hi[w:], lo[: -w or None] ^ lo[w:])
        w *= 2
    acc_hi = acc_lo = None
    pos = 0
    for w in sorted(levels, reverse=True):
        if k & w:
            hi, lo = levels[w]
            ph, pl = hi[pos : pos + n], lo[pos : pos + n]
            acc_hi = ph if acc_hi is None else acc_hi ^ ph
            acc_lo = pl if acc_lo is None else acc_lo ^ pl
            pos += w
    return acc_hi, acc_lo


@partial(jax.jit, static_argnames=("k",))
def window_hashes(seq, k: int):
    """Forward/reverse hashes of every window of ``seq`` (ASCII uint8 [L]).

    Returns (fh, rh) u64 pairs of shape [L - k + 1] (caller guarantees
    L >= k; pad upstream).  Windows containing non-ACGT bases get the
    deterministic garbage the reference also computes for them (seed 0
    terms) — validity masking happens at the engine layer.
    """
    L = seq.shape[0]
    n = L - k + 1
    t = jnp.arange(L, dtype=jnp.int32)
    fterms = u64.srol_var(seed_of(seq), (-t) % SROL_PERIOD)
    rterms = u64.srol_var(cseed_of(seq), t % SROL_PERIOD)
    h = jnp.arange(n, dtype=jnp.int32)
    fh = u64.srol_var(_window_xor(fterms, k, n), (h + k - 1) % SROL_PERIOD)
    rh = u64.srol_var(_window_xor(rterms, k, n), (-h) % SROL_PERIOD)
    return fh, rh


def code_seeds(codes):
    """2-bit base codes [..] (0=A 1=C 2=G 3=T) -> (forward seeds, complement
    seeds) as u64 pairs.  The packed dense pass uploads codes, not ASCII
    (4x less host->device traffic); non-ACGT draft bytes never reach this path
    (engine.flag encodes them as exceptions and patches their windows
    host-side per isAcceptedBase semantics — see flag._exception_hints)."""
    c = jnp.asarray(codes, jnp.int32)
    fs = _sel4(c, [
        (0, ref.SEED_A), (1, ref.SEED_C), (2, ref.SEED_G), (3, ref.SEED_T),
    ])
    cs = _sel4(c, [
        (0, ref.SEED_T), (1, ref.SEED_G), (2, ref.SEED_C), (3, ref.SEED_A),
    ])
    return fs, cs


def window_hashes_codes(codes, k: int):
    """window_hashes over 2-bit base codes [L] instead of ASCII bytes.
    Bit-identical to window_hashes on the decoded ACGT string."""
    L = codes.shape[0]
    n = L - k + 1
    fseed, cseed = code_seeds(codes)
    t = jnp.arange(L, dtype=jnp.int32)
    fterms = u64.srol_var(fseed, (-t) % SROL_PERIOD)
    rterms = u64.srol_var(cseed, t % SROL_PERIOD)
    h = jnp.arange(n, dtype=jnp.int32)
    fh = u64.srol_var(_window_xor(fterms, k, n), (h + k - 1) % SROL_PERIOD)
    rh = u64.srol_var(_window_xor(rterms, k, n), (-h) % SROL_PERIOD)
    return fh, rh


def rotated_seed_tables(k: int):
    """Host-precomputed [k, 256] tables for direct window hashing:

    FROT[i][c] = srol^{k-1-i}(seed(c));  RROT[i][c] = srol^{i}(cseed(c)).
    """
    frot = np.empty((k, 256), dtype=np.uint64)
    rrot = np.empty((k, 256), dtype=np.uint64)
    cs = ref.SEED_TAB[np.arange(256) & CP_OFF]
    for i in range(k):
        frot[i] = ref.srol_vec(ref.SEED_TAB, np.full(256, (k - 1 - i) % SROL_PERIOD))
        rrot[i] = ref.srol_vec(cs, np.full(256, i % SROL_PERIOD))
    return _tab_pair(frot.reshape(-1)), _tab_pair(rrot.reshape(-1)), k


def windows_direct(buf, k: int, starts, frot=None, rrot=None):
    """Hashes of explicit windows: buf ASCII uint8 [...,L], starts int32 [...]
    (window = buf[start : start+k]).  Returns (fh, rh) pairs shaped like
    ``starts``.  Gathers beyond the buffer are the caller's responsibility
    (pad the buffer with sentinel bytes).
    """
    if frot is None:
        frot, rrot, _ = rotated_seed_tables(k)
    idx = starts[..., None] + jnp.arange(k, dtype=jnp.int32)  # [..., k]
    chars = jnp.take(buf, idx, axis=-1) if buf.ndim == 1 else jnp.take_along_axis(
        jnp.broadcast_to(buf, idx.shape[:-1] + buf.shape[-1:]), idx, axis=-1
    )
    pos = jnp.arange(k, dtype=jnp.int32) * 256
    flat = chars.astype(jnp.int32) + pos  # [..., k] indices into [k*256]
    fh = (jnp.asarray(frot[0])[flat], jnp.asarray(frot[1])[flat])
    rh = (jnp.asarray(rrot[0])[flat], jnp.asarray(rrot[1])[flat])

    def _xor_reduce(p):
        return (
            jax.lax.reduce(p[0], np.uint32(0), jax.lax.bitwise_xor, (p[0].ndim - 1,)),
            jax.lax.reduce(p[1], np.uint32(0), jax.lax.bitwise_xor, (p[1].ndim - 1,)),
        )

    return _xor_reduce(fh), _xor_reduce(rh)
