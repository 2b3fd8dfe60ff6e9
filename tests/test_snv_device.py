"""Device-precomputed SNV site decisions (flag.snv_site_data consumed by
native/repair.cpp): bit-identity against the sequential SNV oracle.

SNV mode re-tests every head (/root/reference/ntedit.cpp:1806, 2411-2420)
so the per-site host state machine dominates; the device pass precomputes
each candidate's confirmation count, alternate pre-check bits, and verify
counts, and the engine consumes rows at pristine sites without probing.
These tests drive the full Polisher SNV path (device pass + native
engine) against Oracle.polish_contig on adversarial content: clustered
variants (edit-taint re-evaluation), IUPAC and N bytes (exception
invalidation), lowercase, contig-end windows, ratio thresholds."""

import numpy as np
import pytest

from ntedit_tpu.core import bloom
from ntedit_tpu.core import nthash_ref as nh
from ntedit_tpu.engine import flag, native_repair
from ntedit_tpu.engine.config import EngineConfig
from ntedit_tpu.engine.oracle import Oracle
from ntedit_tpu.engine.polish import Polisher
from ntedit_tpu.utils import simulate

K, H = 25, 3

pytestmark = pytest.mark.skipif(
    not native_repair.available(), reason="native repair library not built"
)


@pytest.fixture(autouse=True)
def _rows_on(monkeypatch):
    # the row-consuming path is opt-in in production (whether the sparse
    # row pass saves more than it costs depends on the deployment); these
    # tests keep it bit-identical for the configurations that enable it
    monkeypatch.setenv("NTEDIT_TPU_SITE_ROWS", "1")


def test_snv_default_cand_path_equals_oracle():
    """The DEFAULT SNV fast path (candidate hint, no rows) == oracle."""
    import os

    os.environ.pop("NTEDIT_TPU_SITE_ROWS", None)
    truth = simulate.random_genome(30000, seed=31)
    sites = np.random.default_rng(32).integers(100, len(truth) - 100, size=10)
    bf = _snv_filter(truth, sites, seed=33)
    cfg = EngineConfig(k=K, hash_num=H, snv=True)
    pol = Polisher(bf, None, cfg)
    want = _assert_equal(pol, cfg, bf, truth)
    assert len(want.subs) >= 3


def _snv_filter(truth, variants_at, seed=0, nbytes=1 << 17):
    """Filter holding the reference k-mers plus variant-allele k-mers."""
    rng = np.random.default_rng(seed)
    variant = truth.copy()
    for pos in variants_at:
        variant[pos] = b"ACGT"[int(rng.integers(0, 4))]
    bf = bloom.KmerBloomFilter.zeros(nbytes, H, K)
    bf.insert_seq(truth)
    bf.insert_seq(variant)
    return bf


def _assert_equal(pol, cfg, bf, seq, header="c"):
    got = pol.polish_contig(header, seq)
    want = Oracle(bf, None, cfg).polish_contig(header, bytes(seq))
    assert got.edited == want.edited
    assert got.subs == want.subs
    return want


def test_snv_device_rows_equal_oracle_basic():
    truth = simulate.random_genome(40000, seed=1)
    sites = np.random.default_rng(2).integers(100, len(truth) - 100, size=15)
    bf = _snv_filter(truth, sites, seed=3)
    cfg = EngineConfig(k=K, hash_num=H, snv=True)
    pol = Polisher(bf, None, cfg)
    want = _assert_equal(pol, cfg, bf, truth)
    assert len(want.subs) >= 5  # variants must surface as records


def test_snv_device_rows_clustered_variants():
    """Variants within k of each other: an accepted edit taints the next
    sites, whose rows must NOT be consumed (live re-evaluation)."""
    truth = simulate.random_genome(30000, seed=4)
    clusters = []
    for base in (5000, 12000, 20000):
        clusters += [base, base + 3, base + 11, base + K - 1, base + K]
    bf = _snv_filter(truth, clusters, seed=5)
    cfg = EngineConfig(k=K, hash_num=H, snv=True)
    pol = Polisher(bf, None, cfg)
    _assert_equal(pol, cfg, bf, truth)


def test_snv_device_rows_exceptions_and_case():
    """N runs, accepted IUPAC codes, and lowercase stretches: exception
    windows must fall back to live probes and still match the oracle."""
    truth = simulate.random_genome(30000, seed=6)
    bf = _snv_filter(truth, [7000, 15000, 22000], seed=7)
    seq = truth.copy()
    seq[9000:9015] = ord("N")
    seq[16000] = ord("R")
    seq[18000:18300] ^= 32  # lowercase stretch (acgt)
    cfg = EngineConfig(k=K, hash_num=H, snv=True)
    pol = Polisher(bf, None, cfg)
    _assert_equal(pol, cfg, bf, seq)


def test_snv_device_rows_near_contig_ends():
    """Variants inside the first/last 2k: rows are invalid there (the
    scans truncate) and the engine must probe live."""
    truth = simulate.random_genome(4000, seed=8)
    bf = _snv_filter(truth, [10, 30, len(truth) - 30, len(truth) - K], seed=9)
    cfg = EngineConfig(k=K, hash_num=H, snv=True)
    pol = Polisher(bf, None, cfg)
    _assert_equal(pol, cfg, bf, truth)


def test_snv_device_rows_ratio_thresholds():
    truth = simulate.random_genome(25000, seed=10)
    bf = _snv_filter(truth, [6000, 13000, 19000], seed=11)
    cfg = EngineConfig(k=K, hash_num=H, snv=True, use_ratio=True,
                       missing_ratio=0.5, edit_ratio=0.5)
    pol = Polisher(bf, None, cfg)
    _assert_equal(pol, cfg, bf, truth)


def test_snv_device_rows_threads_byte_identical():
    truth = simulate.random_genome(60000, seed=12)
    sites = np.random.default_rng(13).integers(100, len(truth) - 100, size=40)
    bf = _snv_filter(truth, sites, seed=14)
    outs = []
    for t in (1, 4):
        cfg = EngineConfig(k=K, hash_num=H, snv=True, threads=t)
        pol = Polisher(bf, None, cfg)
        r = pol.polish_contig("c", truth)
        outs.append((r.edited, r.subs))
    assert outs[0] == outs[1]
    want = Oracle(bf, None, EngineConfig(k=K, hash_num=H, snv=True)
                  ).polish_contig("c", bytes(truth))
    assert outs[0] == (want.edited, want.subs)


def test_snv_site_data_rows_match_scalar_counts():
    """The device rows themselves (pre bits, check_there, verify counts)
    equal scalar recomputation with nthash_ref at sampled sites."""
    truth = simulate.random_genome(20000, seed=15)
    bf = _snv_filter(truth, np.arange(500, 19000, 700), seed=16)
    df = bloom.DeviceFilter.from_host(bf)
    jump = 3
    cand, rows = flag.snv_site_data(truth, df, jump, chunk=1 << 15)
    assert (rows[:, 0] & 1).any()
    strides = [kk for kk in range(K) if kk % jump == 0]
    rng = np.random.default_rng(17)
    for gi in rng.permutation(len(cand))[:40]:
        h = int(cand[gi])
        r = rows[gi]
        if not (r[0] & 1):
            continue
        ct = 0
        for kk in strides:
            w = truth[h + 1 + kk : h + 1 + kk + K]
            hv = nh.extend_hashes(nh.canonical(
                nh.base_forward_hash(w, K), nh.base_reverse_hash(w, K)), K, H)
            ct += int(bf.contains_hashes(hv[None])[0])
        assert ct == r[1], (h, ct, r[1])
        for ci, b in enumerate(b"ACGT"):
            wm = truth[h : h + K].copy()
            wm[K - 1] = b
            hv = nh.extend_hashes(nh.canonical(
                nh.base_forward_hash(wm, K), nh.base_reverse_hash(wm, K)),
                K, H)
            pre = bool(bf.contains_hashes(hv[None])[0])
            assert pre == bool((r[0] >> (1 + ci)) & 1), (h, ci)
            ext = truth[h : h + 2 * K].copy()
            ext[K - 1] = b
            vc = 0
            for kk in strides:
                w2 = ext[1 + kk : 1 + kk + K]
                hv2 = nh.extend_hashes(nh.canonical(
                    nh.base_forward_hash(w2, K),
                    nh.base_reverse_hash(w2, K)), K, H)
                vc += int(bf.contains_hashes(hv2[None])[0])
            assert vc == r[2 + ci], (h, ci, vc, r[2 + ci])


def test_snv_rows_blocked_filter():
    """Blocked-layout filter through the SNV row path == oracle."""
    truth = simulate.random_genome(30000, seed=18)
    rng = np.random.default_rng(19)
    variant = truth.copy()
    for pos in rng.integers(100, len(truth) - 100, size=12):
        variant[pos] = b"ACGT"[int(rng.integers(0, 4))]
    bbf = bloom.BlockedKmerBloomFilter.zeros(1 << 17, H, K)
    bbf.insert_seq(truth)
    bbf.insert_seq(variant)
    cfg = EngineConfig(k=K, hash_num=H, snv=True)
    pol = Polisher(bbf, None, cfg)
    _assert_equal(pol, cfg, bbf, truth)


def test_snv_rows_chunk_boundary_heads():
    """Regression: heads at the very end of a device chunk probe windows
    up to h+k past the chunk — the halo must cover chunk + 2k - 1 bases
    (an earlier halo was one base short, clipping the final gather).
    Variants are planted so candidate heads land exactly on the last
    heads of a 2^15 chunk."""
    chunk = 1 << 15
    truth = simulate.random_genome(3 * chunk + 2000, seed=21)
    # tails at chunk-1 + K-1 and neighbors => candidate heads at the
    # chunk boundary region
    sites = [chunk - 1 + K - 1, chunk + K - 2, 2 * chunk - 1 + K - 1,
             2 * chunk + 5]
    bf = _snv_filter(truth, sites, seed=22)
    cfg = EngineConfig(k=K, hash_num=H, snv=True)
    pol = Polisher(bf, None, cfg, chunk=chunk)
    want = _assert_equal(pol, cfg, bf, truth)
    # the engineered variants must actually produce records
    assert len(want.subs) >= 2
    # and the device rows at those heads must match scalar recomputation
    df = bloom.DeviceFilter.from_host(bf)
    cand, rows = flag.snv_site_data(truth, df, cfg.jump, chunk=chunk)
    strides = [kk for kk in range(K) if kk % cfg.jump == 0]
    n = len(truth) - K + 1
    for h in (chunk - 1, chunk, 2 * chunk - 1):
        gi = np.searchsorted(cand, h)
        if gi >= len(cand) or cand[gi] != h:
            continue
        r = rows[gi]
        if not (r[0] & 1):
            continue
        ct = 0
        for kk in strides:
            w = truth[h + 1 + kk : h + 1 + kk + K]
            hv = nh.extend_hashes(nh.canonical(
                nh.base_forward_hash(w, K), nh.base_reverse_hash(w, K)), K, H)
            ct += int(bf.contains_hashes(hv[None])[0])
        assert ct == r[1], (h, ct, r[1])
