"""64-bit unsigned integer math on uint32 pairs, in JAX.

JAX runs with 64-bit types disabled by default, so every 64-bit quantity
in the compute path — ntHash values, Bloom-filter probe indices — is
represented as a pair ``(hi, lo)`` of ``uint32`` arrays.  All helpers here
are shape-polymorphic and jit-safe (pure jnp ops on uint32).

The split-rotation (``srol``) helpers implement ntHash2's 33/31-bit split
rotate; see ntedit_tpu.core.nthash_ref for the algebra and its mapping to
the reference engine (/root/reference/ntedit.cpp:403-452).

Exact unsigned division/modulo by a *runtime-constant* 64-bit divisor is
implemented via host-precomputed Barrett reciprocals with branch-free
correction (used for btllib-compatible ``hash % num_bits`` Bloom-filter
probes; the framework's native filters use power-of-two sizing where the
modulo is a mask).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
_ONE = np.uint32(1)


def u64(hi, lo) -> Tuple[jnp.ndarray, jnp.ndarray]:
    return jnp.asarray(hi, U32), jnp.asarray(lo, U32)


def from_np(x: np.ndarray | int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """NumPy uint64 (or python int) -> (hi, lo) uint32 device pair."""
    arr = np.asarray(x, dtype=np.uint64)
    return (
        jnp.asarray((arr >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )


def to_np(v) -> np.ndarray:
    """(hi, lo) -> NumPy uint64 (host)."""
    hi, lo = v
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)


def xor(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def or_(a, b):
    return a[0] | b[0], a[1] | b[1]


def and_(a, b):
    return a[0] & b[0], a[1] & b[1]


def eq(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def lt(a, b):
    """Unsigned a < b.

    XLA emits unsigned compares for unsigned dtypes."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def min_(a, b):
    take_a = lt(a, b)
    return jnp.where(take_a, a[0], b[0]), jnp.where(take_a, a[1], b[1])


def select(pred, a, b):
    return jnp.where(pred, a[0], b[0]), jnp.where(pred, a[1], b[1])


def add(a, b):
    """(a + b) mod 2^64."""
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(U32)
    hi = a[0] + b[0] + carry
    return hi, lo


def shr(a, n: int):
    """Logical right shift by a static 0 <= n < 64."""
    hi, lo = a
    if n == 0:
        return hi, lo
    if n < 32:
        return hi >> n, (lo >> n) | (hi << (32 - n))
    if n == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> (n - 32)


def shl(a, n: int):
    """Left shift by a static 0 <= n < 64 (mod 2^64)."""
    hi, lo = a
    if n == 0:
        return hi, lo
    if n < 32:
        return (hi << n) | (lo >> (32 - n)), lo << n
    if n == 32:
        return lo, jnp.zeros_like(lo)
    return lo << (n - 32), jnp.zeros_like(lo)


# ---------------------------------------------------------------------------
# ntHash2 split rotation on (hi, lo):
#   low part  = bits 0..32  (33 bits: lo plus bit0 of hi), rotates mod 33
#   high part = bits 33..63 (31 bits: hi >> 1), rotates mod 31
# ---------------------------------------------------------------------------

SPLIT_LOW_BITS = 33
SPLIT_HIGH_BITS = 31
SROL_PERIOD = SPLIT_LOW_BITS * SPLIT_HIGH_BITS  # 1023


def srol1(a):
    """Split-rotate-left by 1 (bit63 -> bit33, bit32 -> bit0)."""
    hi, lo = a
    new_lo = (lo << _ONE) | (hi & _ONE)
    new_hi = (hi << _ONE) | (lo >> np.uint32(31))
    new_hi = (new_hi & np.uint32(0xFFFFFFFD)) | ((hi >> np.uint32(31)) << _ONE)
    return new_hi, new_lo


def _split(a):
    """-> (p33, p31) where p33 = bits 0..32 in a uint64-as-2xu32? No:
    p33 as (bit32_flag uint32, low32); p31 = hi >> 1 (fits one u32)."""
    hi, lo = a
    return (hi & _ONE), lo, hi >> _ONE  # bit32, bits0..31, bits33..63


def _join(b32, lo, p31):
    return (p31 << _ONE) | b32, lo


def srol_const(a, d: int):
    """srol^d with static d, via the 33/31 split."""
    d = d % SROL_PERIOD
    if d == 0:
        return a
    d33 = d % SPLIT_LOW_BITS
    d31 = d % SPLIT_HIGH_BITS
    b32, lo, p31 = _split(a)
    # rotate 33-bit value (b32:lo) left by d33
    if d33:
        # v = b32*2^32 + lo, 33 bits. rotl33(v, d) = ((v << d) | (v >> (33-d))) & (2^33-1)
        sh = d33
        inv = SPLIT_LOW_BITS - d33
        # compute v << sh (34..65 bit) as u64-lite: only need low 33 bits of result
        # low33(v<<sh) = ((lo << sh) | carry-ins) ... do it with 64-bit emulation:
        v_hi, v_lo = shl((b32, lo), sh)
        w_hi, w_lo = shr((b32, lo), inv)
        r_hi = (v_hi | w_hi) & _ONE
        r_lo = v_lo | w_lo
        b32, lo = r_hi, r_lo
    if d31:
        p31 = ((p31 << d31) | (p31 >> (SPLIT_HIGH_BITS - d31))) & np.uint32(0x7FFFFFFF)
    return _join(b32, lo, p31)


def srol_var(a, d):
    """srol^d with per-element dynamic d (int32 array, any values >= 0)."""
    d = jnp.asarray(d, jnp.int32) % SROL_PERIOD
    d33 = (d % SPLIT_LOW_BITS).astype(U32)
    d31 = (d % SPLIT_HIGH_BITS).astype(U32)
    b32, lo, p31 = _split(a)
    # 33-bit rotate by d33 (0..32): build v as (b32, lo); v<<sh and v>>(33-sh)
    sh = d33
    inv = np.uint32(SPLIT_LOW_BITS) - d33  # 1..33
    # v << sh on the 33-bit value: result bit32..0.  Use 64-bit paths with
    # variable shifts; uint32 << 32 is undefined-ish in XLA, so mask shifts.
    def _shl64v(hi, lo, n):
        n = n.astype(U32)
        big = n >= np.uint32(32)
        n_small = jnp.where(big, n - np.uint32(32), n)
        # n in [0,31] now
        lo_sh = lo << n_small
        n1 = jnp.where(n_small > 0, n_small, _ONE)  # avoid maxui: Mosaic
        hi_sh = (hi << n_small) | jnp.where(
            n_small > 0, lo >> (np.uint32(32) - n1), jnp.zeros_like(lo)
        )
        hi_out = jnp.where(big, lo_sh, hi_sh)
        lo_out = jnp.where(big, jnp.zeros_like(lo), lo_sh)
        return hi_out, lo_out

    def _shr64v(hi, lo, n):
        n = n.astype(U32)
        big = n >= np.uint32(32)
        n_small = jnp.where(big, n - np.uint32(32), n)
        hi_sh = hi >> n_small
        n1 = jnp.where(n_small > 0, n_small, _ONE)
        lo_sh = (lo >> n_small) | jnp.where(
            n_small > 0, hi << (np.uint32(32) - n1), jnp.zeros_like(hi)
        )
        n31 = jnp.where(n_small < np.uint32(31), n_small, np.uint32(31))
        lo_out = jnp.where(big, hi >> n31, lo_sh)
        lo_out = jnp.where(big & (n_small >= np.uint32(32)), jnp.zeros_like(lo), lo_out)
        hi_out = jnp.where(big, jnp.zeros_like(hi), hi_sh)
        return hi_out, lo_out

    v_hi, v_lo = _shl64v(b32, lo, sh)
    w_hi, w_lo = _shr64v(b32, lo, inv)
    nb32 = (v_hi | w_hi) & _ONE
    nlo = v_lo | w_lo
    nb32 = jnp.where(sh == 0, b32, nb32)
    nlo = jnp.where(sh == 0, lo, nlo)
    # 31-bit rotate by d31
    inv31 = np.uint32(SPLIT_HIGH_BITS) - d31
    inv31c = jnp.where(inv31 < np.uint32(31), inv31, np.uint32(31))
    np31 = ((p31 << d31) | (p31 >> inv31c)) & np.uint32(0x7FFFFFFF)
    np31 = jnp.where(d31 == 0, p31, np31)
    return _join(nb32, nlo, np31)


# ---------------------------------------------------------------------------
# 64x64 multiplication via 16-bit limbs (exact, uint32 accumulators).
# ---------------------------------------------------------------------------

def _limbs16(a):
    hi, lo = a
    m = np.uint32(0xFFFF)
    return lo & m, lo >> np.uint32(16), hi & m, hi >> np.uint32(16)


def mul_lo(a, b):
    """(a * b) mod 2^64."""
    a0, a1, a2, a3 = _limbs16(a)
    b0, b1, b2, b3 = _limbs16(b)
    # column c = sum of ai*bj with i+j == c, c in 0..3 (16-bit columns)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p02 = a0 * b2
    p11 = a1 * b1
    p20 = a2 * b0
    p03 = a0 * b3
    p12 = a1 * b2
    p21 = a2 * b1
    p30 = a3 * b0
    m = np.uint32(0xFFFF)
    c0 = p00 & m
    carry = p00 >> np.uint32(16)
    s1 = carry + (p01 & m) + (p10 & m)
    c1 = s1 & m
    carry = (s1 >> np.uint32(16)) + (p01 >> np.uint32(16)) + (p10 >> np.uint32(16))
    s2 = carry + (p02 & m) + (p11 & m) + (p20 & m)
    c2 = s2 & m
    carry = (s2 >> np.uint32(16)) + (p02 >> np.uint32(16)) + (p11 >> np.uint32(16)) + (
        p20 >> np.uint32(16)
    )
    s3 = carry + p03 + p12 + p21 + p30  # only low 16 bits of s3 are kept
    c3 = s3 & m
    return (c3 << np.uint32(16)) | c2, (c1 << np.uint32(16)) | c0


def mul_full(a, b):
    """Full 128-bit product -> ((hi64), (lo64)) as two u32-pairs."""
    a0, a1, a2, a3 = _limbs16(a)
    b0, b1, b2, b3 = _limbs16(b)
    al = (a0, a1, a2, a3)
    bl = (b0, b1, b2, b3)
    m = np.uint32(0xFFFF)
    cols = [jnp.zeros_like(a0) for _ in range(8)]
    for i in range(4):
        for j in range(4):
            p = al[i] * bl[j]
            cols[i + j] = cols[i + j] + (p & m)
            cols[i + j + 1] = cols[i + j + 1] + (p >> np.uint32(16))
    # propagate carries (each col < 2^16 * 9 fits easily in u32)
    out = []
    carry = jnp.zeros_like(a0)
    for c in range(8):
        s = cols[c] + carry
        out.append(s & m)
        carry = s >> np.uint32(16)
    return (
        ((out[7] << np.uint32(16)) | out[6], (out[5] << np.uint32(16)) | out[4]),
        ((out[3] << np.uint32(16)) | out[2], (out[1] << np.uint32(16)) | out[0]),
    )


def mul_hi(a, b):
    """High 64 bits of the 128-bit product."""
    return mul_full(a, b)[0]


# ---------------------------------------------------------------------------
# Exact modulo by a runtime-constant divisor (Barrett with correction).
# ---------------------------------------------------------------------------

class Divisor(NamedTuple):
    """Host-precomputed Barrett parameters for n % d, n < 2^64."""

    d_hi: np.uint32
    d_lo: np.uint32
    m_hi: np.uint32  # floor(2^(64+s)/d) as u64 (only if not pow2)
    m_lo: np.uint32
    s: int
    is_pow2: bool
    mask_hi: np.uint32  # d-1 when pow2
    mask_lo: np.uint32


def make_divisor(d: int) -> Divisor:
    assert 0 < d < 1 << 64
    if d & (d - 1) == 0:
        mask = d - 1
        return Divisor(
            np.uint32(d >> 32), np.uint32(d & 0xFFFFFFFF),
            np.uint32(0), np.uint32(0), 0, True,
            np.uint32(mask >> 32), np.uint32(mask & 0xFFFFFFFF),
        )
    s = d.bit_length() - 1  # 2^s < d < 2^(s+1)
    magic = (1 << (64 + s)) // d  # < 2^64 since d > 2^s
    return Divisor(
        np.uint32(d >> 32), np.uint32(d & 0xFFFFFFFF),
        np.uint32(magic >> 32), np.uint32(magic & 0xFFFFFFFF),
        s, False,
        np.uint32(0), np.uint32(0),
    )


def mod_divisor(n, div: Divisor):
    """n % d for u32-pair n, exact for all n < 2^64."""
    if div.is_pow2:
        return n[0] & div.mask_hi, n[1] & div.mask_lo
    d = (jnp.full_like(n[0], div.d_hi), jnp.full_like(n[1], div.d_lo))
    magic = (jnp.full_like(n[0], div.m_hi), jnp.full_like(n[1], div.m_lo))
    q = shr(mul_hi(n, magic), div.s)  # q <= true quotient <= q + 2
    r = sub(n, mul_lo(q, d))
    # up to two corrections
    for _ in range(2):
        ge = ~lt(r, d)
        r = select(ge, sub(r, d), r)
    return r


def sub(a, b):
    """(a - b) mod 2^64."""
    lo = a[1] - b[1]
    borrow = (a[1] < b[1]).astype(U32)
    hi = a[0] - b[0] - borrow
    return hi, lo
