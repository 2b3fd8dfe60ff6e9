"""On-device BF construction (DeviceFilterBuilder) vs host semantics.

Forced onto the CPU backend via NTEDIT_TPU_DEVICE_BUILD=1 — the same jit
stages run compiled on the GPU.
"""

import gzip
import os

import numpy as np
import pytest

from ntedit_tpu.core import bfbuild, bloom
from ntedit_tpu.utils import simulate


@pytest.fixture()
def reads(tmp_path):
    rng = np.random.default_rng(1)
    genome = simulate.random_genome(20_000, seed=9)
    path = tmp_path / "reads.fq.gz"
    with gzip.open(path, "wb") as f:
        for i in range(600):  # ~3x coverage of 100bp reads
            s = int(rng.integers(0, len(genome) - 100))
            seq = bytes(genome[s : s + 100])
            f.write(b"@r%d\n" % i + seq + b"\n+\n" + b"I" * 100 + b"\n")
    return str(path), genome


def _forced_device(monkeypatch):
    monkeypatch.setenv("NTEDIT_TPU_DEVICE_BUILD", "1")


def test_device_build_cutoff1_matches_host_blocked(tmp_path, reads, monkeypatch):
    _forced_device(monkeypatch)
    path, _genome = reads
    bf_dev, hist, cut = bfbuild.build_read_filter([path], k=25, cutoff=1)
    assert isinstance(bf_dev, bloom.BlockedKmerBloomFilter)
    # host blocked filter over the same k-mers, same size: identical bits
    host = bloom.BlockedKmerBloomFilter.zeros(bf_dev.bytes, bf_dev.hash_num, 25)
    for h in bfbuild._iter_hash_batches([path], 25):
        host.insert_base(h)
    assert host.words.size == bf_dev.words.size
    assert (host.words == bf_dev.words).all()


def test_scatter_or_words_exact_under_duplicates():
    """The sort+segmented-scan scatter-OR must be exact for adversarial
    batches: repeated indices, overlapping masks, bits already set, and
    sentinel (dropped) entries — the cases where a naive scatter-add
    corrupts neighbouring bits."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    nw = 64
    for trial in range(20):
        n = int(rng.integers(1, 400))
        widx = rng.integers(0, nw, size=n).astype(np.uint32)
        mask = rng.integers(1, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
        drop = rng.random(n) < 0.2
        widx[drop] = 0xFFFFFFFF
        mask[drop] = 0
        start = rng.integers(0, 1 << 32, size=nw, dtype=np.uint64).astype(np.uint32)
        want = start.copy()
        for w, m in zip(widx, mask):
            if w != 0xFFFFFFFF:
                want[w] |= m
        got = np.asarray(
            bfbuild.scatter_or_words(
                jnp.asarray(start), jnp.asarray(widx), jnp.asarray(mask)
            )
        )
        assert (got == want).all(), f"trial {trial} mismatch"


def test_scatter_or_words_exact_across_sub_batches(monkeypatch):
    """The multi-sub-batch fori_loop path (n > _SORT_SUB — every production
    2^24-base batch takes it) must stay exact when duplicate word indices
    SPAN sub-batch boundaries: each sub-batch's gather must observe the
    previous sub-batch's writes (the carry the docstring promises).
    _SORT_SUB is shrunk so the loop path runs at test size."""
    import jax.numpy as jnp

    monkeypatch.setattr(bfbuild, "_SORT_SUB", 64)
    rng = np.random.default_rng(11)
    nw = 32  # few words + many entries => duplicates certain across subs
    for trial in range(6):
        n = int(rng.integers(200, 700))  # 4-11 sub-batches incl. pad tail
        widx = rng.integers(0, nw, size=n).astype(np.uint32)
        mask = (np.uint32(1) << rng.integers(0, 32, size=n).astype(np.uint32))
        drop = rng.random(n) < 0.1
        widx[drop] = 0xFFFFFFFF
        mask[drop] = 0
        start = rng.integers(0, 1 << 32, size=nw, dtype=np.uint64).astype(np.uint32)
        want = start.copy()
        for w, m in zip(widx, mask):
            if w != 0xFFFFFFFF:
                want[w] |= m
        got = np.asarray(
            bfbuild.scatter_or_words(
                jnp.asarray(start), jnp.asarray(widx), jnp.asarray(mask)
            )
        )
        assert (got == want).all(), f"trial {trial} mismatch"


def test_device_build_plain_layout_matches_host(tmp_path, reads, monkeypatch):
    """The 'plain' layout builds the btllib bit layout on device — the
    artifact the unmodified reference engine consumes.  Bit-identical to a
    host KmerBloomFilter insert over the same k-mers at the same pow2
    size."""
    _forced_device(monkeypatch)
    path, _genome = reads
    from ntedit_tpu.core import nthash_ref as nh

    k, hnum = 25, 3
    nbits = 1 << 22
    builder = bfbuild.DeviceFilterBuilder(k, hnum, nbits, 1 << 10, layout="plain")
    for buf in bfbuild._iter_separated_buffers([path], k):
        builder.insert_batch(buf, 1)
    bf_dev = builder.finish()
    assert isinstance(bf_dev, bloom.KmerBloomFilter)
    with pytest.raises(RuntimeError):
        builder.finish()  # clear already-finished error
    host = bloom.KmerBloomFilter.zeros(nbits // 8, hnum, k)
    for h in bfbuild._iter_hash_batches([path], k):
        host.insert_hashes(nh.extend_hashes_vec(h, k, hnum))
    assert (host.data == bf_dev.data).all()


def test_device_build_large_filter_smoke(monkeypatch):
    """2^33-bit (1 GiB) build — past the old 2^31-bit cap — on the test
    backend: inserted k-mers all present, absent k-mers mostly not."""
    _forced_device(monkeypatch)
    k = 25
    g = simulate.random_genome(40_000, seed=5)
    builder = bfbuild.DeviceFilterBuilder(k, 3, 1 << 33, 1 << 10)
    builder.insert_batch(g, 1)
    bf = builder.finish()
    assert bf.bits == 1 << 33
    assert bf.contains_seq_kmers(g).all()
    other = simulate.random_genome(5_000, seed=6)
    assert bf.contains_seq_kmers(other).mean() < 0.01


def test_device_build_cutoff2_no_false_negatives(tmp_path, reads, monkeypatch):
    _forced_device(monkeypatch)
    path, genome = reads
    bf_dev, hist, cut = bfbuild.build_read_filter([path], k=25, cutoff=2)
    assert cut == 2
    # true multiplicities of all read k-mers
    from collections import Counter

    counts = Counter()
    for h in bfbuild._iter_hash_batches([path], 25):
        counts.update(h.tolist())
    keys = np.fromiter(counts.keys(), dtype=np.uint64, count=len(counts))
    mult = np.fromiter(counts.values(), dtype=np.int64, count=len(counts))
    got = bf_dev.contains_base(keys)
    solid = mult >= 2
    assert got[solid].all(), "count-min thresholding must not drop solid k-mers"
    # singletons mostly rejected (count-min collisions allow a small leak)
    leak = got[~solid].mean() if (~solid).any() else 0.0
    assert leak < 0.05, f"singleton leak too high: {leak:.3f}"
