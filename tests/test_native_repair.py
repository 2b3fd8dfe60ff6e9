"""Native sparse-repair engine (native/repair.cpp) == sequential oracle,
bit-for-bit.

Drives ntedit_tpu.engine.native_repair.polish_contig_native — the
production host repair path — against the Python oracle on the same
workload families the wavefront tests cover, comparing both the edited
sequence and the rendered _edited.fa/_changes.tsv/_variants.vcf outputs.
Also exercises the gate-hint fast-forward path (gated native run ==
full-scan native run == oracle) and the capacity-retry path (the engine
must restart from a pristine contig buffer, not the partially-edited one).
"""

import io

import numpy as np
import pytest

from ntedit_tpu.core import bloom, nthash_ref as nh
from ntedit_tpu.engine import native_repair
from ntedit_tpu.engine.config import EngineConfig
from ntedit_tpu.engine.oracle import Oracle
from ntedit_tpu.io import writers
from ntedit_tpu.utils import simulate

pytestmark = pytest.mark.skipif(
    not native_repair.available(), reason="native repair library not built"
)


def render(result, snv=False):
    d, r, v = io.StringIO(), io.StringIO(), io.StringIO()
    writers.write_contig(result, d, r, v, snv=snv)
    return d.getvalue() + "\x00" + r.getvalue() + "\x00" + v.getvalue()


def assert_equivalent(draft, bf, bfrep=None, gate_hint=None, **cfg_kw):
    cfg = EngineConfig(k=bf.k, hash_num=bf.hash_num, **cfg_kw)
    oracle = Oracle(bf, bfrep, cfg)
    slow = oracle.polish_contig("ctg", bytes(draft))
    fast = native_repair.polish_contig_native(
        oracle.bloom, oracle.bloomrep, cfg, "ctg", bytes(draft),
        gate_hint=gate_hint,
    )
    assert fast is not None
    assert fast.edited == slow.edited
    assert fast.subs == slow.subs
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
def test_clustered_errors(min_gap):
    truth = simulate.random_genome(8000, seed=82 + min_gap)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=6e-3, ins_rate=1.5e-3, del_rate=1.5e-3,
        min_gap=min_gap, seed=83 + min_gap,
    )
    bf = simulate.truth_bf(truth, 25)
    assert_equivalent(draft, bf)


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


def test_blocked_filter():
    wl = simulate.make_workload(length=8000, k=25, seed=130)
    blocked = bloom.BlockedKmerBloomFilter.zeros(1 << 16, 3, 25)
    blocked.insert_seq(wl.truth)
    assert_equivalent(wl.draft, blocked)


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


def test_gate_hint_equals_full_scan():
    """Gated run == full scan == oracle.  The hint is the real device gate
    bitmap (all heads whose k-mer is absent), plus a stale-hint variant
    (every head) which must behave identically."""
    wl = simulate.make_workload(length=10000, k=25, seed=140)
    cfg = EngineConfig(k=wl.bf.k, hash_num=wl.bf.hash_num)
    oracle = Oracle(wl.bf, None, cfg)
    # derive exact gates on host
    fh, rh = nh.all_window_hashes(wl.draft, 25)
    hashes = nh.extend_hashes_vec(nh.canonical(fh, rh), 25, 3)
    present = wl.bf.contains_hashes(hashes)
    gates = np.nonzero(~present)[0].astype(np.int64)
    full = native_repair.polish_contig_native(
        oracle.bloom, None, cfg, "ctg", bytes(wl.draft))
    gated = native_repair.polish_contig_native(
        oracle.bloom, None, cfg, "ctg", bytes(wl.draft), gate_hint=gates)
    every = native_repair.polish_contig_native(
        oracle.bloom, None, cfg, "ctg", bytes(wl.draft),
        gate_hint=np.arange(len(wl.draft) - 24, dtype=np.int64))
    slow = oracle.polish_contig("ctg", bytes(wl.draft))
    assert full.edited == gated.edited == every.edited == slow.edited
    assert full.subs == gated.subs == every.subs == slow.subs


def test_capacity_retry_restarts_pristine():
    """A capacity retry must re-polish the ORIGINAL contig: the engine
    applies substitutions in place before the -2/-3 retcode surfaces, so
    reusing the buffer would silently polish an already-edited sequence."""
    wl = simulate.make_workload(length=12000, k=25, seed=150)
    cfg = EngineConfig(k=wl.bf.k, hash_num=wl.bf.hash_num)
    oracle = Oracle(wl.bf, None, cfg)
    normal = native_repair.polish_contig_native(
        oracle.bloom, None, cfg, "ctg", bytes(wl.draft))
    assert len(normal.subs) > 4  # the tiny caps below genuinely overflow
    tiny = native_repair.polish_contig_native(
        oracle.bloom, None, cfg, "ctg", bytes(wl.draft), initial_caps=(2, 2))
    assert tiny.edited == normal.edited
    assert tiny.subs == normal.subs


def test_param_validation_rejects_bad_k():
    """The C ABI must reject out-of-range params instead of overflowing
    fixed buffers."""
    truth = simulate.random_genome(2000, seed=160)
    bf = simulate.truth_bf(truth, 25)
    cfg = EngineConfig(k=bf.k, hash_num=bf.hash_num)
    oracle = Oracle(bf, None, cfg)
    import dataclasses

    # validate() does not clamp k (it comes from the BF header), so the
    # doctored value reaches the C ABI, which must return -1 -> None
    bad = dataclasses.replace(cfg, k=300)
    res = native_repair.polish_contig_native(
        oracle.bloom, None, bad, "ctg", bytes(truth))
    assert res is None


# ---------------------------------------------------------------------------
# Segmented parallel repair == sequential native == oracle
# ---------------------------------------------------------------------------

def _host_gates(draft, bf, k=25, snv=False):
    fh, rh = nh.all_window_hashes(draft, k)
    hashes = nh.extend_hashes_vec(nh.canonical(fh, rh), k, bf.hash_num)
    if hasattr(bf, "counters"):
        present = bf.count_hashes(hashes) > 0
    elif hasattr(bf, "contains_hashes"):
        present = bf.contains_hashes(hashes)
    else:
        present = bf.contains_base(nh.canonical(fh, rh))
    gate = ~present if not snv else np.ones_like(present)
    return np.nonzero(gate)[0].astype(np.int64)


@pytest.mark.parametrize("threads", [2, 4])
@pytest.mark.parametrize("seed", [400, 401, 402])
def test_segmented_equals_sequential(threads, seed):
    rng = np.random.default_rng(seed)
    truth = simulate.random_genome(30000, seed=seed)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=3e-3, ins_rate=1e-3, del_rate=1e-3,
        min_gap=int(rng.integers(30, 120)), seed=seed + 1,
    )
    bf = simulate.truth_bf(truth, 25)
    cfg = EngineConfig(k=25, hash_num=3, mode=int(rng.integers(0, 3)))
    o = Oracle(bf, None, cfg)
    gates = _host_gates(draft, bf)
    seq_res = native_repair.polish_contig_native(
        o.bloom, None, cfg, "c", bytes(draft), gate_hint=gates)
    seg_res = native_repair.polish_contig_segmented(
        o.bloom, None, cfg, "c", bytes(draft), gates, threads=threads)
    assert seg_res is not None
    assert seg_res.edited == seq_res.edited
    assert seg_res.subs == seq_res.subs
    assert render(seg_res) == render(seq_res)


def test_segmented_clustered_errors_one_segment():
    # errors all within one influence zone: degenerates to one segment
    truth = simulate.random_genome(5000, seed=420)
    draft = truth.copy()
    for p in (2500, 2510, 2520):
        draft[p] = ord("A") if truth[p] != ord("A") else ord("C")
    bf = simulate.truth_bf(truth, 25)
    cfg = EngineConfig(k=25, hash_num=3)
    o = Oracle(bf, None, cfg)
    gates = _host_gates(draft, bf)
    seq_res = native_repair.polish_contig_native(
        o.bloom, None, cfg, "c", bytes(draft), gate_hint=gates)
    seg_res = native_repair.polish_contig_segmented(
        o.bloom, None, cfg, "c", bytes(draft), gates, threads=4)
    assert seg_res.edited == seq_res.edited and seg_res.subs == seq_res.subs


def test_segmented_no_gates():
    truth = simulate.random_genome(3000, seed=430)
    bf = simulate.truth_bf(truth, 25)
    cfg = EngineConfig(k=25, hash_num=3)
    o = Oracle(bf, None, cfg)
    res = native_repair.polish_contig_segmented(
        o.bloom, None, cfg, "c", bytes(truth), np.zeros(0, np.int64))
    assert res.edited == truth.tobytes() and res.subs == []


def test_segmented_mask_and_cbf():
    truth = simulate.random_genome(20000, seed=440)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=2e-3, ins_rate=0, del_rate=0, seed=441)
    cbf = bloom.KmerCountingBloomFilter8.zeros(1 << 18, 3, 25)
    fh, rh = nh.all_window_hashes(truth, 25)
    hashes = nh.extend_hashes_vec(nh.canonical(fh, rh), 25, 3)
    for _ in range(4):
        cbf.insert_hashes(hashes)
    cfg = EngineConfig(k=25, hash_num=3, min_threshold=2, mask=True)
    o = Oracle(cbf, None, cfg)
    # CBF gate: count < min_threshold also gates
    dfh, drh = nh.all_window_hashes(draft, 25)
    counts = cbf.count_hashes(nh.extend_hashes_vec(nh.canonical(dfh, drh), 25, 3))
    gates = np.nonzero(counts < 2)[0].astype(np.int64)
    seq_res = native_repair.polish_contig_native(
        o.bloom, None, cfg, "c", bytes(draft), gate_hint=gates)
    seg_res = native_repair.polish_contig_segmented(
        o.bloom, None, cfg, "c", bytes(draft), gates, threads=4)
    assert seg_res.edited == seq_res.edited and seg_res.subs == seq_res.subs
    assert render(seg_res) == render(seq_res)


def test_pipelined_equals_sequential():
    """The streaming pipelined path (chunked gate feed + overlapped segment
    repair) must match the one-shot sequential native scan exactly."""
    truth = simulate.random_genome(50000, seed=500)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=2e-3, ins_rate=5e-4, del_rate=5e-4, seed=501)
    bf = simulate.truth_bf(truth, 25)
    cfg = EngineConfig(k=25, hash_num=3)
    o = Oracle(bf, None, cfg)
    gates = _host_gates(draft, bf)
    seq_res = native_repair.polish_contig_native(
        o.bloom, None, cfg, "c", bytes(draft), gate_hint=gates)

    def chunk_feed(chunk=4096):
        n = len(draft) - 24
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            sel = gates[(gates >= start) & (gates < end)]
            yield end, sel

    pip = native_repair.polish_contig_pipelined(
        o.bloom, None, cfg, "c", bytes(draft), chunk_feed(), threads=4)
    assert pip is not None
    assert pip.edited == seq_res.edited
    assert pip.subs == seq_res.subs
    assert render(pip) == render(seq_res)


def test_polisher_pipelined_end_to_end():
    """Polisher default engine (pipelined) through the device gate pass ==
    sequential oracle engine, rendered outputs byte-identical."""
    from ntedit_tpu.engine.polish import Polisher

    wl = simulate.make_workload(length=30000, k=25, seed=510)
    cfg = EngineConfig(k=wl.bf.k, hash_num=wl.bf.hash_num)
    pol = Polisher(wl.bf, cfg=cfg)
    assert pol.engine == "pipelined"
    fast = pol.polish_contig("ctg", np.asarray(wl.draft))
    slow = Oracle(wl.bf, None, cfg).polish_contig("ctg", bytes(wl.draft))
    assert fast.edited == slow.edited
    assert fast.subs == slow.subs
    assert render(fast) == render(slow)


# ---------------------------------------------------------------------------
# SNV fast path: device candidate hints == full SNV scan
# ---------------------------------------------------------------------------

def _snv_polisher(bf, **cfg_kw):
    from ntedit_tpu.engine.polish import Polisher

    cfg = EngineConfig(k=bf.k, hash_num=bf.hash_num, snv=True, **cfg_kw)
    return Polisher(bf, cfg=cfg)


@pytest.mark.parametrize("seed", [600, 601, 602])
def test_snv_fast_path_equals_oracle(seed):
    rng = np.random.default_rng(seed)
    truth = simulate.random_genome(15000, seed=seed)
    variant = truth.copy()
    # scattered variants plus a clustered pair within k (exercises the
    # dirty-window live re-evaluation after an SNV substitution edit)
    sites = list(rng.choice(np.arange(100, 14900), size=12, replace=False))
    sites += [7000, 7010]
    for p in sites:
        variant[p] = ord("A") if variant[p] != ord("A") else ord("C")
    bf = simulate.truth_bf(truth, 25)
    bf.insert_seq(variant)
    pol = _snv_polisher(bf)
    assert pol._snv_fast_eligible()
    fast = pol.polish_contig("ctg", truth)
    cfg = EngineConfig(k=25, hash_num=3, snv=True)
    slow = Oracle(bf, None, cfg).polish_contig("ctg", bytes(truth))
    assert fast.edited == slow.edited
    assert fast.subs == slow.subs
    assert render(fast, snv=True) == render(slow, snv=True)
    assert len(fast.subs) > 0


def test_snv_fast_path_iupac_and_lowercase():
    truth = simulate.random_genome(4000, seed=610)
    draft = truth.copy()
    draft[1500] = ord("R")   # IUPAC draft base: all four alternates tried
    draft[2000:2100] += 32   # lowercase region
    variant = truth.copy()
    variant[2050] = ord("A") if truth[2050] != ord("A") else ord("C")
    bf = simulate.truth_bf(truth, 25)
    bf.insert_seq(variant)
    pol = _snv_polisher(bf)
    fast = pol.polish_contig("ctg", draft)
    cfg = EngineConfig(k=25, hash_num=3, snv=True)
    slow = Oracle(bf, None, cfg).polish_contig("ctg", bytes(draft))
    assert fast.edited == slow.edited and fast.subs == slow.subs


def test_snv_fast_path_ineligible_falls_back():
    """mode 2 / mask / CBF / reject BF configs must not use the candidate
    hint (it would under-approximate) — and still match the oracle."""
    truth = simulate.random_genome(3000, seed=620)
    variant = truth.copy()
    variant[1500] = ord("A") if truth[1500] != ord("A") else ord("C")
    bf = simulate.truth_bf(truth, 25)
    bf.insert_seq(variant)
    for kw in ({"mode": 2}, {"mask": True}):
        pol = _snv_polisher(bf, **kw)
        assert not pol._snv_fast_eligible()
        fast = pol.polish_contig("ctg", truth)
        cfg = EngineConfig(k=25, hash_num=3, snv=True, **kw)
        slow = Oracle(bf, None, cfg).polish_contig("ctg", bytes(truth))
        assert fast.edited == slow.edited and fast.subs == slow.subs


def test_ratio_thresholds_match_oracle():
    """-X/-Y ratio thresholds (use_ratio path, incl. the deletion formula
    asymmetry (1 + k/j)*Y, ntedit.cpp:1531-1535) through the native
    engine."""
    wl = simulate.make_workload(length=10000, k=25, seed=800)
    assert_equivalent(wl.draft, wl.bf, use_ratio=True,
                      missing_ratio=0.5, edit_ratio=0.5)
    assert_equivalent(wl.draft, wl.bf, use_ratio=True,
                      missing_ratio=0.3, edit_ratio=0.7, mode=1)


@pytest.mark.parametrize("k", [15, 32, 52])
def test_nondefault_k_values(k):
    """k is read from the filter header and can be any value (the
    reference recommends k52/k55 for human SNV calling, README.md:273);
    the hash algebra, trial tables, and native engine are k-parametric."""
    truth = simulate.random_genome(9000, seed=900 + k)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=3e-3, ins_rate=8e-4, del_rate=8e-4, seed=901 + k
    )
    bf = simulate.truth_bf(truth, k)
    assert_equivalent(draft, bf)


def test_nondefault_k_snv():
    k = 52
    truth = simulate.random_genome(6000, seed=910)
    p = 3000
    variant = truth.copy()
    variant[p] = ord("A") if truth[p] != ord("A") else ord("C")
    bf = simulate.truth_bf(truth, k)
    bf.insert_seq(variant)
    assert_equivalent(truth, bf, snv=True)
