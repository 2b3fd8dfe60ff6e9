"""Bloom-filter construction: the ntCard + ntStat + make_genome_bf path.

Replaces the reference pipeline's three external native tools (SURVEY.md
§2.2) with one module over the same nthash/bloom core the engine uses:

* ``count_histogram``  — ntCard's role: k-mer frequency histogram
  (F1 = total k-mers, F0 = distinct, f_i spectrum), saved/loaded in
  ntCard's .hist text format (demo/ntcard_k25.hist).  Exact by default;
  for large read sets it switches to ntCard-style hash sampling (count
  k-mers whose canonical hash falls in a 2^-s slice of hash space, scale
  by 2^s) — the estimator contract the pipeline actually relies on
  (ntedit_run_pipeline.smk:168-176, 250-256 reads only F0 and the shape).
* ``solid_cutoff``     — ntStat's ``--solid`` role: derive the
  error/true-kmer threshold from the histogram valley
  (run-ntedit:90-96; rule ntstat passes ``-cmin 0`` to mean "derive",
  ntedit_run_pipeline.smk:163).
* ``build_read_filter`` — ntStat ``filter``'s role: BF (or counting CBF)
  of read k-mers with multiplicity >= cutoff, sized by the
  Broder–Mitzenmacher formula for the post-cutoff cardinality
  (``ntstat filter -k K -cmin C -e FPR -f hist -o out [--counts]``,
  ntedit_run_pipeline.smk:165,202).
* ``build_genome_bf``  — ntedit_make_genome_bf's role: BF over genome
  k-mers, sized from --bf | --num_elements | total genome length with
  the same formula (src/ntedit_make_genome_bf.cpp:41-47,124-158).

K-mers containing non-ACGT bases are skipped everywhere (btllib ntHash
semantics).  Counting uses the CBF's count-min behavior: a k-mer's count
is the minimum across its slots, so multiplicities are never undercounted
and the >=cutoff test has no false negatives.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional, Sequence

import numpy as np

from ntedit_tpu.core import bloom
from ntedit_tpu.core import nthash_ref as nh
from ntedit_tpu.io import fastx

_ACGT = np.zeros(256, dtype=bool)
for _c in b"ACGTacgt":
    _ACGT[_c] = True


def valid_canonical_hashes(seq: np.ndarray, k: int) -> np.ndarray:
    """Canonical ntHash2 base hashes of every ACGT-only k-mer window."""
    L = len(seq)
    if L < k:
        return np.empty(0, dtype=np.uint64)
    fh, rh = nh.all_window_hashes(seq, k)
    acc = _ACGT[seq].astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(acc)])
    ok = (cs[k:] - cs[:-k]) == k
    return nh.canonical(fh, rh)[ok]


def _iter_seqs(paths: Sequence[str]) -> Iterable[np.ndarray]:
    for p in paths:
        for rec in fastx.read_fastx(p):
            yield rec.seq


_FLUSH = 1 << 22  # base hashes buffered before one vectorized insert


def _separated(seq_bytes: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """Concatenate records with a single 0x00 separator byte between them:
    the separator is non-ACGT, so the validity mask of one whole-buffer
    hash pass automatically rejects windows straddling record
    boundaries."""
    lens = np.diff(offs)
    out = np.zeros(len(seq_bytes) + len(lens), dtype=np.uint8)
    shift = np.repeat(np.arange(len(lens)), lens)
    out[np.arange(len(seq_bytes)) + shift] = seq_bytes
    return out


def _iter_hash_batches(paths: Sequence[str], k: int) -> Iterable[np.ndarray]:
    """Canonical base hashes of all valid k-mers, in large batches.

    With the native batch reader, each multi-megabyte record batch is
    hashed in ONE vectorized pass over the separator-joined buffer
    (per-read numpy calls are what make short-read FASTQ hashing slow);
    otherwise falls back to per-record hashing with flush batching."""
    from ntedit_tpu.io import native

    if native.get_lib() is not None:
        for p in paths:
            for seq_bytes, offs, _h, _q in native.read_batches(p, want_headers=False):
                h = valid_canonical_hashes(_separated(seq_bytes, offs), k)
                if len(h):
                    yield h
        return
    buf: list[np.ndarray] = []
    n = 0
    for seq in _iter_seqs(paths):
        h = valid_canonical_hashes(seq, k)
        if len(h):
            buf.append(h)
            n += len(h)
        if n >= _FLUSH:
            yield np.concatenate(buf)
            buf, n = [], 0
    if buf:
        yield np.concatenate(buf)


# ---------------------------------------------------------------------------
# Device-side filter construction (ntStat's hot path on the accelerator)
# ---------------------------------------------------------------------------

_DEV_BATCH = 1 << 24  # bases per device batch (chosen on an earlier
# accelerator; not measured on the H100 yet)


def _device_backend_ok() -> bool:
    if os.environ.get("NTEDIT_TPU_DEVICE_BUILD", "auto") == "0":
        return False
    try:
        import jax

        return jax.devices()[0].platform != "cpu" or (
            os.environ.get("NTEDIT_TPU_DEVICE_BUILD") == "1"
        )
    except Exception:
        return False


_SENT = np.uint32(0xFFFFFFFF)  # sorts after every real word index


_SORT_SUB = 1 << 21  # entries per in-program sort: one bounded sort shape
# whatever the batch (chosen on an earlier accelerator, where a single
# 16M+-element sort failed to compile; not measured on the H100 yet)


def _scatter_or_sub(words, widx, mask):
    import jax
    import jax.numpy as jnp

    w_s, m_s = jax.lax.sort((widx, mask), num_keys=1)

    def comb(a, b):
        wa, ma = a
        wb, mb = b
        return wb, mb | jnp.where(wa == wb, ma, np.uint32(0))

    _, m_acc = jax.lax.associative_scan(comb, (w_s, m_s))
    last = jnp.concatenate(
        [w_s[:-1] != w_s[1:], jnp.ones((1,), bool)]
    )
    live = last & (w_s != _SENT)
    gidx = jnp.where(live, w_s, np.uint32(0)).astype(jnp.int32)
    old = words[gidx]
    addv = jnp.where(live, m_acc & ~old, np.uint32(0))
    return words.at[gidx].add(addv)


def scatter_or_words(words, widx, mask):
    """Exact deterministic bitwise-OR scatter: ``words[widx[i]] |= mask[i]``
    for every entry, under jit, with only O(batch) transients.

    XLA has no scatter-OR combiner, and scatter-add corrupts on duplicate
    bits. So: sort the (word index, probe mask) pairs by index, OR-combine
    equal-index runs with a segmented associative scan, then gather the
    old words at each run's LAST entry and scatter-ADD only the bits still
    missing (``m & ~old``) — adds of disjoint powers of two at unique
    indices are carry-free, so the add IS the OR. Entries with ``widx ==
    0xFFFFFFFF`` are dropped (invalid / below-cutoff windows). This
    replaces the byte-per-bit + pack build (which held an nbits-byte
    transient and capped filters at 2^31 bits): the only resident array is
    the packed word array itself, so filters scale to device memory (2^36
    bits = 8 GiB at int32 gather indices).

    Large batches run as a fori_loop of ``_SORT_SUB``-entry sub-scatters
    (one compiled sort shape; the word carry makes cross-sub-batch
    duplicates exact: each sub-batch's gather sees the previous one's
    writes)."""
    import jax
    import jax.numpy as jnp

    n = widx.shape[0]
    if n <= _SORT_SUB:
        return _scatter_or_sub(words, widx, mask)
    pad = (-n) % _SORT_SUB
    if pad:
        widx = jnp.concatenate([widx, jnp.full((pad,), _SENT)])
        mask = jnp.concatenate([mask, jnp.zeros((pad,), jnp.uint32)])
    wi = widx.reshape(-1, _SORT_SUB)
    mi = mask.reshape(-1, _SORT_SUB)

    def body(i, w):
        return _scatter_or_sub(w, wi[i], mi[i])

    return jax.lax.fori_loop(0, wi.shape[0], body, words)


class DeviceFilterBuilder:
    """Streaming on-device k-mer counting + threshold insertion.

    Replaces the ntStat filter stage's hot loop (SURVEY.md §2.2): each
    separator-joined record batch is uploaded once; canonical hashing,
    validity masking, count-min updates, and threshold-gated insertion all
    run on the device.  Only the finished filter array is downloaded.

    Insertion goes straight into the packed uint32 word array via
    ``scatter_or_words`` — no byte-per-bit transient — so human-scale
    filters (2^35 bits = 4 GiB, SURVEY §5.8) build on one chip; the
    ceiling is 2^36 bits (8 GiB, int32 gather indices).

    ``layout``: 'blocked' (framework-native BlockedKmerBloomFilter; one
    word + hash_num 5-bit offsets per k-mer) or 'plain' (btllib bit
    layout, hash_num independent bit positions — the artifact the
    unmodified reference engine consumes).
    """

    def __init__(self, k: int, hash_num: int, nbits_pow2: int,
                 cbf_slots_pow2: int, layout: str = "blocked"):
        import jax
        import jax.numpy as jnp

        if nbits_pow2 > (1 << 36):
            raise ValueError(
                f"DeviceFilterBuilder supports at most 2^36 bits (8 GiB "
                f"filter, int32 word-gather ceiling); got {nbits_pow2} — "
                f"build per-range partial filters (split the k-mer stream "
                f"by hash range) and OR the word arrays on host"
            )
        if layout not in ("blocked", "plain"):
            raise ValueError(f"unknown layout {layout!r}")
        self.k = k
        self.hash_num = hash_num
        self.nbits = nbits_pow2
        self.slots = cbf_slots_pow2
        self.layout = layout
        self._jnp = jnp
        self._jax = jax
        self.counters = jnp.zeros((cbf_slots_pow2,), jnp.int32)
        self.words = jnp.zeros((nbits_pow2 // 32,), jnp.uint32)
        self._count_fns = {}
        self._insert_fns = {}

    # -- host-side 2-bit encode: the build batch travels packed (4x less
    # host->device traffic than ASCII)
    def _encode(self, buf: np.ndarray):
        """ASCII [L] -> (packed codes u32 [ceil(L/16)], window-validity
        bitmap u32 [ceil(n/32)], n).  Non-ACGT bytes (separators, N) code
        as 0 and invalidate every window containing them."""
        from ntedit_tpu.engine import flag as flagm

        k = self.k
        L = len(buf)
        n = L - k + 1
        codes = flagm._CODE_TAB[np.asarray(buf, np.uint8)]
        bad = codes == 255
        if bad.any():
            codes = np.where(bad, 0, codes).astype(np.uint8)
            cs = np.concatenate([[0], np.cumsum((~bad).astype(np.int32))])
            valid = (cs[k:] - cs[:-k]) == k
        else:
            valid = np.ones(n, dtype=bool)
        padc = (-L) % 16
        if padc:
            codes = np.concatenate([codes, np.zeros(padc, np.uint8)])
        x = codes.view("<u4")
        y = x | (x >> np.uint32(6))
        z = (y | (y >> np.uint32(12))) & np.uint32(255)
        packed = z.astype(np.uint8).view("<u4")
        padv = (-n) % 32
        vb = np.concatenate([valid, np.zeros(padv, bool)]) if padv else valid
        vw = np.packbits(vb, bitorder="little").view("<u4")
        return packed, vw, n

    # -- jit stage builders (specialized per packed batch shape) --
    def _hashes(self, packed, validw, n: int):
        import jax.numpy as jnp

        from ntedit_tpu.core import nthash as nt
        from ntedit_tpu.utils import u64 as u64m

        k = self.k
        shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, :]
        codes = ((packed[:, None] >> shifts) & jnp.uint32(3)).astype(jnp.uint8)
        seqc = codes.reshape(-1)[: n + k - 1]
        fh, rh = nt.window_hashes_codes(seqc, k)
        can = u64m.min_(fh, rh)
        lanes = jnp.arange(32, dtype=jnp.uint32)[None, :]
        valid = (((validw[:, None] >> lanes) & jnp.uint32(1)) == 1).reshape(-1)[:n]
        return can, valid

    def _count_fn(self, shape):
        fn = self._count_fns.get(shape)
        if fn is None:
            jax, jnp = self._jax, self._jnp
            slots = self.slots
            n = shape[2]

            def step(packed, validw, counters):
                can, valid = self._hashes(packed, validw, n)
                idxs = []
                for j in range(self.hash_num):
                    h = can if j == 0 else _mix_pair(can, j, self.k)
                    idx = (h[1] & np.uint32(slots - 1)).astype(jnp.int32)
                    # invalid windows all hit slot capacity-1 sentinel? no:
                    # route them to a dedicated overflow slot 0 and subtract
                    idxs.append(jnp.where(valid, idx, -1))
                upd = jnp.zeros((slots,), jnp.int32)
                for idx in idxs:
                    upd = upd.at[jnp.where(idx >= 0, idx, 0)].add(
                        jnp.where(idx >= 0, 1, 0)
                    )
                return jnp.minimum(counters + jnp.minimum(upd, 255), 255)

            fn = self._count_fns[shape] = jax.jit(step, donate_argnums=(2,))
        return fn

    def _insert_fn(self, shape, cutoff: int):
        key = (shape, cutoff)
        fn = self._insert_fns.get(key)
        if fn is None:
            jax, jnp = self._jax, self._jnp
            slots, nbits = self.slots, self.nbits
            nw = nbits // 32
            wbits = nw.bit_length() - 1
            layout = self.layout
            n = shape[2]

            def step(packed, validw, counters, words):
                can, valid = self._hashes(packed, validw, n)
                from ntedit_tpu.utils import u64 as u64m

                if cutoff > 1:
                    cnt = None
                    for j in range(self.hash_num):
                        h = can if j == 0 else _mix_pair(can, j, self.k)
                        idx = (h[1] & np.uint32(slots - 1)).astype(jnp.int32)
                        got = counters[idx]
                        cnt = got if cnt is None else jnp.minimum(cnt, got)
                    ok = valid & (cnt >= cutoff)
                else:
                    ok = valid
                if layout == "blocked":
                    # one word per k-mer, hash_num 5-bit offsets in its
                    # high hash bits (BlockedKmerBloomFilter layout)
                    widx = can[1] & np.uint32(nw - 1)
                    mask = jnp.zeros_like(can[1])
                    for j in range(self.hash_num):
                        off = u64m.shr(can, wbits + 5 * j)[1] & np.uint32(31)
                        mask = mask | (jnp.uint32(1) << off)
                    ws = [jnp.where(ok, widx, _SENT)]
                    ms = [jnp.where(ok, mask, np.uint32(0))]
                else:
                    # plain btllib layout: hash_num independent bit
                    # positions, bit index = extended hash mod nbits
                    # (pow2 mask; little-endian bit order in uint32 words
                    # matches the byte layout, bloom._pack_words)
                    ws, ms = [], []
                    hi_mask = np.uint32((nbits >> 32) - 1) if nbits > (1 << 32) else np.uint32(0)
                    for j in range(self.hash_num):
                        h = can if j == 0 else _mix_pair(can, j, self.k)
                        if nbits <= (1 << 32):
                            lo = h[1] & np.uint32(nbits - 1)
                            widx = lo >> np.uint32(5)
                        else:
                            widx = ((h[0] & hi_mask) << np.uint32(27)) | (
                                h[1] >> np.uint32(5)
                            )
                        off = h[1] & np.uint32(31)
                        ws.append(jnp.where(ok, widx, _SENT))
                        ms.append(jnp.where(ok, jnp.uint32(1) << off, np.uint32(0)))
                return scatter_or_words(
                    words, jnp.concatenate(ws), jnp.concatenate(ms)
                )

            fn = self._insert_fns[key] = jax.jit(step, donate_argnums=(3,))
        return fn

    def _upload(self, buf_padded):
        """Encode + upload one batch; accepts host ASCII or an already-
        encoded (packed, validw, n) triple (dual-build callers encode
        once and feed both builders)."""
        jnp = self._jnp
        if isinstance(buf_padded, tuple):
            packed, vw, n = buf_padded
        else:
            packed, vw, n = self._encode(np.asarray(buf_padded))
        pd = packed if hasattr(packed, "devices") else jnp.asarray(packed)
        vd = vw if hasattr(vw, "devices") else jnp.asarray(vw)
        return pd, vd, (len(packed), len(vw), n)

    def count_batch(self, buf_padded) -> None:
        pd, vd, shape = self._upload(buf_padded)
        self.counters = self._count_fn(shape)(pd, vd, self.counters)

    def insert_batch(self, buf_padded, cutoff: int) -> None:
        if self.words is None:
            raise RuntimeError("builder already finished")
        pd, vd, shape = self._upload(buf_padded)
        self.words = self._insert_fn(shape, cutoff)(
            pd, vd, self.counters, self.words
        )

    def encode_batch(self, buf: np.ndarray):
        """Host-encode + device-put once for feeding multiple builders
        (same k required)."""
        packed, vw, n = self._encode(np.asarray(buf))
        jnp = self._jnp
        return jnp.asarray(packed), jnp.asarray(vw), n

    def device_words(self):
        """The packed word array, still on device (bench/mesh paths that
        probe without a host round-trip)."""
        if self.words is None:
            raise RuntimeError("builder already finished")
        return self.words

    def finish(self):
        """Download the packed words; returns the host filter
        (BlockedKmerBloomFilter or plain KmerBloomFilter by layout)."""
        if self.words is None:
            raise RuntimeError("builder already finished")
        words = np.asarray(self.words)
        self.words = None  # device array released; builder is finished
        if self.layout == "blocked":
            return bloom.BlockedKmerBloomFilter(words, self.hash_num, self.k)
        return bloom.KmerBloomFilter(
            words.view(np.uint8).copy(), self.hash_num, self.k
        )


def _mix_pair(can, i: int, k: int):
    """extend_hashes mixing on a u32 pair (device)."""
    import jax.numpy as jnp

    from ntedit_tpu.core import nthash_ref as _ref
    from ntedit_tpu.utils import u64 as u64m

    mult = (i ^ (k * int(_ref.MULTISEED))) & 0xFFFFFFFFFFFFFFFF
    mp = (
        jnp.full_like(can[0], np.uint32(mult >> 32)),
        jnp.full_like(can[1], np.uint32(mult & 0xFFFFFFFF)),
    )
    t = u64m.mul_lo(can, mp)
    return u64m.xor(t, u64m.shr(t, int(_ref.MULTISHIFT)))


def _iter_separated_buffers(paths: Sequence[str], k: int,
                            pad_to: int = _DEV_BATCH):
    """Separator-joined record buffers padded to bucket sizes (pow2 steps
    down from _DEV_BATCH) so device stages compile a bounded set of
    shapes.  Separator/pad byte 0x00 is non-ACGT: straddle windows are
    masked by validity.  Long buffers are split with exactly k-1 bytes of
    overlap so every window is covered exactly once (count-min updates
    must not double-count)."""
    from ntedit_tpu.io import native

    def bucket(n: int) -> int:
        b = 1 << 12
        while b < n:
            b <<= 1
        return min(b, pad_to)

    def emit_all(buf: np.ndarray):
        step = pad_to - (k - 1)
        for s in range(0, max(1, len(buf) - (k - 1)), step):
            piece = buf[s : s + pad_to]
            out = np.zeros(bucket(len(piece)), dtype=np.uint8)
            out[: len(piece)] = piece
            yield out

    if native.get_lib() is not None:
        for p in paths:
            for seq_bytes, offs, _h, _q in native.read_batches(p, want_headers=False):
                yield from emit_all(_separated(seq_bytes, offs))
        return
    pend: list[np.ndarray] = []
    n = 0
    for seq in _iter_seqs(paths):
        pend.append(seq)
        pend.append(np.zeros(1, np.uint8))
        n += len(seq) + 1
        if n >= pad_to:
            yield from emit_all(np.concatenate(pend))
            pend, n = [], 0
    if pend:
        yield from emit_all(np.concatenate(pend))


def _sample_key(h: np.ndarray) -> np.ndarray:
    """Avalanche mix (splitmix64 finalizer) for hash-slice sampling.

    The canonical ntHash value is a combination of the forward and
    reverse-complement hashes whose raw top bits are NOT uniform (it
    behaves like a min of two uniforms, density 2(1-x)); slicing on it
    directly would over-sample ~2x.  A bijective mixer decorrelates the
    slice from that skew while preserving distinctness."""
    with np.errstate(over="ignore"):
        x = h * np.uint64(0x9E3779B97F4A7C15)
        x ^= x >> np.uint64(29)
        x = x * np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(32)
    return x


# ---------------------------------------------------------------------------
# Histogram (ntCard role)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Histogram:
    k: int
    f1: int                 # total k-mers (F1)
    f0: int                 # distinct k-mers (F0)
    spectrum: np.ndarray    # spectrum[i] = # distinct k-mers with count i (i>=1)

    def f(self, i: int) -> int:
        return int(self.spectrum[i]) if 0 < i < len(self.spectrum) else 0

    def solid_cardinality(self, cutoff: int) -> int:
        """Distinct k-mers with multiplicity >= cutoff."""
        below = int(self.spectrum[1:cutoff].sum()) if cutoff > 1 else 0
        return max(1, self.f0 - below)

    def save(self, path: str) -> None:
        """ntCard .hist text format (demo/ntcard_k25.hist)."""
        with open(path, "w") as f:
            f.write(f"F1\t{self.f1}\n")
            f.write(f"F0\t{self.f0}\n")
            for i in range(1, len(self.spectrum)):
                f.write(f"{i}\t{int(self.spectrum[i])}\n")

    @classmethod
    def load(cls, path: str, k: int = 0) -> "Histogram":
        f1 = f0 = 0
        pairs = {}
        with open(path) as f:
            for line in f:
                key, val = line.split()
                if key == "F1":
                    f1 = int(val)
                elif key == "F0":
                    f0 = int(val)
                else:
                    pairs[int(key)] = int(val)
        top = max(pairs) if pairs else 0
        spec = np.zeros(top + 1, dtype=np.int64)
        for i, v in pairs.items():
            spec[i] = v
        return cls(k=k, f1=f1, f0=f0, spectrum=spec)


def count_histogram(
    paths: Sequence[str],
    k: int,
    max_count: int = 255,
    sample_budget: int = 1 << 26,
) -> Histogram:
    """Stream reads, build the k-mer multiplicity histogram.

    Starts exact (sample_log2 = 0); if the number of retained sampled
    hashes would exceed ``sample_budget``, re-samples to a thinner hash
    slice (each step halves retention) and scales counts back up —
    ntCard's estimator contract with a simpler mechanism.
    """
    s = 0
    total = 0
    kept: list[np.ndarray] = []
    kept_n = 0
    for seq in _iter_seqs(paths):
        h = valid_canonical_hashes(seq, k)
        total += len(h)
        if s:
            h = h[(_sample_key(h) >> np.uint64(64 - s)) == 0]
        kept.append(h)
        kept_n += len(h)
        while kept_n > sample_budget:
            s += 1
            kept_n = 0
            for i, arr in enumerate(kept):
                arr = arr[(_sample_key(arr) >> np.uint64(64 - s)) == 0]
                kept[i] = arr
                kept_n += len(arr)
    sampled = np.concatenate(kept) if kept else np.empty(0, np.uint64)
    _uniq, counts = np.unique(sampled, return_counts=True)
    scale = 1 << s
    counts = np.minimum(counts, max_count)
    spec_s = np.bincount(counts, minlength=max_count + 1)
    spectrum = (spec_s * scale).astype(np.int64)
    spectrum[0] = 0
    return Histogram(k=k, f1=total, f0=int(len(_uniq)) * scale, spectrum=spectrum)


def solid_cutoff(hist: Histogram) -> int:
    """First valley of the multiplicity spectrum: errors dominate low
    counts with a steeply falling f_i; genuine coverage forms a later
    peak.  The first i where f_i stops falling separates them (the
    ntHits/ntStat solid heuristic; legacy contract at ntedit-make:122-127).
    Clamped to [2, 255]."""
    f = hist.spectrum
    top = len(f) - 1
    i = 2
    while i < top and f[i] > f[i + 1]:
        i += 1
    return int(min(max(i, 2), 255))


# ---------------------------------------------------------------------------
# Read-derived BF / CBF (ntStat filter role)
# ---------------------------------------------------------------------------

def device_filter_sizes(hist: Histogram, cutoff: int, hash_num: int = 3,
                        fpr: float = 0.01) -> tuple:
    """(filter bits, count-min slots) of the on-device read filter build:
    power-of-two sizes for the post-cutoff and the distinct cardinality."""
    nbits = bloom.pow2_size_bytes(hist.solid_cardinality(cutoff), hash_num,
                                  fpr) * 8
    cbf_slots = bloom.bf_size_bytes(hist.f0, hash_num, fpr) * 8
    return nbits, 1 << max(12, (cbf_slots - 1).bit_length())


def build_read_filter(
    paths: Sequence[str],
    k: int,
    cutoff: int = 2,
    solid: bool = False,
    fpr: float = 0.01,
    hash_num: int = 3,
    counts: bool = False,
    hist: Optional[Histogram] = None,
):
    """BF (or CBF when counts=True) of read k-mers with multiplicity
    >= cutoff.  ``solid`` derives the cutoff from the histogram
    (ntstat -cmin 0 semantics).  Returns (filter, hist, cutoff)."""
    if hist is None:
        hist = count_histogram(paths, k)
    if solid:
        cutoff = solid_cutoff(hist)
    cutoff = max(1, int(cutoff))

    n_solid = hist.solid_cardinality(cutoff)
    out_bytes = bloom.bf_size_bytes(n_solid, hash_num, fpr)

    # counting filters need as many SLOTS as the bit-array formula gives
    # bits (one byte per slot): same collision behavior, 8x the memory
    cbf_slots = bloom.bf_size_bytes(hist.f0, hash_num, fpr) * 8
    if counts:
        cbf = bloom.KmerCountingBloomFilter8.zeros(cbf_slots, hash_num, k)
        for h in _iter_hash_batches(paths, k):
            cbf.insert_hashes(nh.extend_hashes_vec(h, k, hash_num))
        return cbf, hist, cutoff

    if _device_backend_ok():
        # on-device build (ntStat hot path on the accelerator): count-min counting
        # + threshold insertion into the framework-native blocked filter
        nbits, slots = device_filter_sizes(hist, cutoff, hash_num, fpr)
        builder = DeviceFilterBuilder(k, hash_num, nbits, slots)
        if cutoff > 1:
            for buf in _iter_separated_buffers(paths, k):
                builder.count_batch(buf)
        for buf in _iter_separated_buffers(paths, k):
            builder.insert_batch(buf, cutoff)
        return builder.finish(), hist, cutoff

    bf = bloom.KmerBloomFilter.zeros(out_bytes, hash_num, k)
    if cutoff <= 1:
        for h in _iter_hash_batches(paths, k):
            bf.insert_hashes(nh.extend_hashes_vec(h, k, hash_num))
        return bf, hist, cutoff

    # two passes: count-min multiplicities, then threshold-insert
    counter = bloom.KmerCountingBloomFilter8.zeros(cbf_slots, hash_num, k)
    for h in _iter_hash_batches(paths, k):
        counter.insert_hashes(nh.extend_hashes_vec(h, k, hash_num))
    for h in _iter_hash_batches(paths, k):
        ext = nh.extend_hashes_vec(h, k, hash_num)
        ok = counter.count_hashes(ext) >= cutoff
        if ok.any():
            bf.insert_hashes(ext[ok])
    return bf, hist, cutoff


# ---------------------------------------------------------------------------
# Genome BF (ntedit_make_genome_bf role)
# ---------------------------------------------------------------------------

def build_genome_bf(
    genome_paths: Sequence[str],
    k: int,
    fpr: float = 0.01,
    hash_num: int = 3,
    bf_bytes: Optional[int] = None,
    num_elements: Optional[int] = None,
) -> bloom.KmerBloomFilter:
    """BF over all genome k-mers.  Size precedence --bf > --num_elements >
    total genome length, each through the Broder–Mitzenmacher formula
    (src/ntedit_make_genome_bf.cpp:124-138)."""
    if bf_bytes is None:
        n = num_elements if num_elements is not None else fastx.total_length(genome_paths)
        bf_bytes = bloom.bf_size_bytes(max(1, n), hash_num, fpr)
    bf = bloom.KmerBloomFilter.zeros(bf_bytes, hash_num, k)
    for h in _iter_hash_batches(genome_paths, k):
        bf.insert_hashes(nh.extend_hashes_vec(h, k, hash_num))
    return bf
