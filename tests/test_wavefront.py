"""Wavefront batched repair == sequential oracle, bit-for-bit.

The wavefront engine (ntedit_tpu/engine/wavefront.py) commits batched
round-start decisions only when provably equal to the sequential result;
these tests drive it directly with an all-positions gate hint (so the
engine's own live gating is exercised) and with tiny eval chunks (so the
multi-round deferral / rest-list coordinate-delta paths are exercised),
comparing rendered outputs against the scalar oracle.
"""

import io

import numpy as np
import pytest

from ntedit_tpu.core import bloom, nthash_ref as nh
from ntedit_tpu.engine import wavefront
from ntedit_tpu.engine.config import EngineConfig
from ntedit_tpu.engine.oracle import Oracle
from ntedit_tpu.engine.polish import Polisher
from ntedit_tpu.io import writers
from ntedit_tpu.utils import simulate


def render(result, snv=False):
    d, r, v = io.StringIO(), io.StringIO(), io.StringIO()
    writers.write_contig(result, d, r, v, snv=snv)
    return d.getvalue() + "\x00" + r.getvalue() + "\x00" + v.getvalue()


def run_wavefront(draft, bf, bfrep=None, eval_chunk=1 << 15, **cfg_kw):
    cfg = EngineConfig(k=bf.k, hash_num=bf.hash_num, **cfg_kw)
    oracle = Oracle(bf, bfrep, cfg)
    heads = np.arange(max(0, len(draft) - cfg.k + 1))
    return wavefront.polish_contig_wavefront(
        oracle, "ctg", bytes(draft), heads, eval_chunk=eval_chunk
    )


def assert_equivalent(draft, bf, bfrep=None, eval_chunk=1 << 15, **cfg_kw):
    cfg = EngineConfig(k=bf.k, hash_num=bf.hash_num, **cfg_kw)
    slow = Oracle(bf, bfrep, cfg).polish_contig("ctg", bytes(draft))
    try:
        fast = run_wavefront(draft, bf, bfrep, eval_chunk=eval_chunk, **cfg_kw)
    except wavefront.WavefrontBailout:
        pytest.skip("bailout: sequential fallback owns this input")
    assert fast.edited == slow.edited
    assert render(fast, snv=cfg.snv) == render(slow, snv=cfg.snv)
    return fast


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_modes_with_indels(mode):
    wl = simulate.make_workload(length=12000, k=25, seed=80)
    res = assert_equivalent(wl.draft, wl.bf, mode=mode)
    assert res.edited == wl.truth.tobytes()


def test_clean_contig_no_edits():
    truth = simulate.random_genome(4000, seed=81)
    bf = simulate.truth_bf(truth, 25)
    res = assert_equivalent(truth, bf)
    assert res.edited == truth.tobytes()


@pytest.mark.parametrize("min_gap", [5, 12, 30])
def test_clustered_errors_multi_round(min_gap):
    # errors inside each other's influence zones force deferrals and
    # multiple wavefront rounds
    truth = simulate.random_genome(8000, seed=82 + min_gap)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=6e-3, ins_rate=1.5e-3, del_rate=1.5e-3,
        min_gap=min_gap, seed=83 + min_gap,
    )
    bf = simulate.truth_bf(truth, 25)
    assert_equivalent(draft, bf)


def test_tiny_eval_chunk_rest_delta():
    # eval_chunk smaller than the site count: the deferred "rest" list must
    # be re-based by the cell-index delta of committed indels
    truth = simulate.random_genome(6000, seed=90)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=4e-3, ins_rate=2e-3, del_rate=2e-3, min_gap=40, seed=91
    )
    bf = simulate.truth_bf(truth, 25)
    assert_equivalent(draft, bf, eval_chunk=3)


def test_errors_near_contig_ends():
    truth = simulate.random_genome(900, seed=92)
    draft = truth.copy()
    draft[26] = ord("A") if truth[26] != ord("A") else ord("C")
    draft[-26] = ord("A") if truth[-26] != ord("A") else ord("C")
    bf = simulate.truth_bf(truth, 25)
    assert_equivalent(draft, bf)


def test_non_acgt_runs():
    truth = simulate.random_genome(4000, seed=93)
    draft = truth.copy()
    draft[1000:1015] = ord("N")
    draft[2000] = ord("R")
    draft[2500] = ord("A") if truth[2500] != ord("A") else ord("C")
    bf = simulate.truth_bf(truth, 25)
    assert_equivalent(draft, bf)


def test_lowercase_preserved():
    truth = simulate.random_genome(3000, seed=94)
    draft = truth.copy()
    draft[500:600] += 32
    draft[550] = ord("a") if truth[550] != ord("A") else ord("c")
    bf = simulate.truth_bf(truth, 25)
    assert_equivalent(draft, bf)


def test_mask_mode():
    truth = simulate.random_genome(2500, seed=95)
    draft = truth.copy()
    p = 1200
    draft[p] = ord("A") if truth[p] != ord("A") else ord("C")
    bf = bloom.KmerBloomFilter.zeros(1 << 14, 3, 25)
    bf.insert_seq(truth[: p - 40])
    bf.insert_seq(truth[p + 40 :])
    assert_equivalent(draft, bf, mask=True)


def test_snv_mode():
    truth = simulate.random_genome(1500, seed=96)
    p = 700
    variant = truth.copy()
    variant[p] = ord("A") if truth[p] != ord("A") else ord("C")
    bf = simulate.truth_bf(truth, 25)
    bf.insert_seq(variant)
    assert_equivalent(truth, bf, snv=True)


def test_cbf_and_reject():
    truth = simulate.random_genome(3000, seed=97)
    draft = truth.copy()
    for p in (700, 1400, 2100):
        draft[p] = ord("A") if truth[p] != ord("A") else ord("C")
    cbf = bloom.KmerCountingBloomFilter8.zeros(1 << 17, 3, 25)
    fh, rh = nh.all_window_hashes(truth, 25)
    hashes = nh.extend_hashes_vec(nh.canonical(fh, rh), 25, 3)
    for _ in range(4):
        cbf.insert_hashes(hashes)
    rep = bloom.KmerBloomFilter.zeros(1 << 12, 3, 25)
    rep.insert_seq(truth[1350:1460])
    assert_equivalent(draft, cbf, bfrep=rep, min_threshold=2)


@pytest.mark.parametrize("seed", range(100, 110))
def test_fuzz_dense(seed):
    rng = np.random.default_rng(seed)
    truth = simulate.random_genome(int(rng.integers(2000, 6000)), seed=seed)
    draft, _ = simulate.inject_errors(
        truth,
        sub_rate=float(rng.uniform(1e-3, 8e-3)),
        ins_rate=float(rng.uniform(0, 2e-3)),
        del_rate=float(rng.uniform(0, 2e-3)),
        min_gap=int(rng.integers(4, 50)),
        seed=seed + 1,
    )
    bf = simulate.truth_bf(truth, 25)
    assert_equivalent(draft, bf, mode=int(rng.integers(0, 3)))


def test_polisher_wavefront_vs_sequential_engine():
    # end-to-end through the Polisher with the device gate hint
    wl = simulate.make_workload(length=10000, k=25, seed=120)
    cfg = EngineConfig(k=wl.bf.k, hash_num=wl.bf.hash_num)
    wf = Polisher(wl.bf, cfg=cfg, engine="wavefront").polish_contig(
        "ctg", np.asarray(wl.draft)
    )
    seq = Polisher(wl.bf, cfg=cfg, engine="sequential", use_device=True)
    # engine attr forces sequential only when use_device=False; force directly
    seq.engine = "sequential"
    sq = seq.polish_contig("ctg", np.asarray(wl.draft))
    assert wf.edited == sq.edited
    assert render(wf) == render(sq)


def test_snv_candidate_hint_equals_full_scan():
    """SNV through the wavefront with the device candidate hint (the
    Polisher fallback path) == oracle full scan."""
    from ntedit_tpu.engine import flag
    from ntedit_tpu.utils import simulate

    wl = simulate.make_workload(length=30_000, k=25, seed=21)
    cfg = EngineConfig(k=25, hash_num=3, snv=True).validate()
    o = Oracle(wl.bf, None, cfg)
    full = o.polish_contig("c", bytes(wl.draft))
    df = bloom.DeviceFilter.from_host(wl.bf)
    cand = flag.snv_candidate_positions(wl.draft, df)
    o2 = Oracle(wl.bf, None, cfg)
    hinted = wavefront.polish_contig_wavefront(o2, "c", bytes(wl.draft), cand)
    assert hinted.edited == full.edited
    assert hinted.subs == full.subs
