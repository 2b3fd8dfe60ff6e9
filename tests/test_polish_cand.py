"""Device pre-verification of polish substitution candidates:
flag.polish_candidate_masks computes, on device, the engine's
first-level contains(changelast) probe for every gated head on the
pristine draft; repair.cpp consults the mask only at provably-pristine
windows, so the native result is BIT-IDENTICAL with or without masks.

Checks: (1) mask semantics against a host brute-force changelast rehash;
(2) native engine identity with/without masks across fuzzed workloads
(subs + indels, clustered errors, mask mode, lowercase, non-ACGT runs);
(3) the threaded segmented path slices masks consistently; (4) the
Polisher opt-in env wiring (NTEDIT_TPU_CAND=1).

Reference parity: the pre-check being replaced is ntedit.cpp:1923-1928
(substituted k-mer present) — the mask is a device-evaluated cache of
exactly that probe.
"""

import io

import numpy as np
import pytest

from ntedit_tpu.core import bloom, nthash_ref as nh
from ntedit_tpu.engine import flag, native_repair
from ntedit_tpu.engine.config import EngineConfig
from ntedit_tpu.engine.oracle import Oracle
from ntedit_tpu.io import writers
from ntedit_tpu.utils import simulate

pytestmark = pytest.mark.skipif(
    not native_repair.available(), reason="native repair library not built"
)

ACGT = b"ACGT"


def render(result, snv=False):
    d, r, v = io.StringIO(), io.StringIO(), io.StringIO()
    writers.write_contig(result, d, r, v, snv=snv)
    return d.getvalue() + "\x00" + r.getvalue() + "\x00" + v.getvalue()


def _host_masks(draft, bf, gates, k):
    """Brute-force reference: rebuild each gate's window with the last
    base replaced and probe the host filter."""
    out = np.zeros(len(gates), dtype=np.uint8)
    up = np.frombuffer(bytes(draft).upper(), dtype=np.uint8)
    for i, g in enumerate(gates):
        win = up[g : g + k]
        if not all(c in ACGT for c in win.tobytes()):
            out[i] = 0xFF
            continue
        m = 0
        for ci, b in enumerate(ACGT):
            w = win.copy()
            w[-1] = b
            fh, rh = nh.all_window_hashes(w, k)
            hashes = nh.extend_hashes_vec(nh.canonical(fh, rh), k, bf.hash_num)
            if hasattr(bf, "contains_hashes"):
                present = bool(bf.contains_hashes(hashes)[0])
            else:
                present = bool(bf.contains_base(nh.canonical(fh, rh))[0])
            m |= int(present) << ci
        out[i] = m
    return out


def test_mask_semantics_vs_host_bruteforce():
    wl = simulate.make_workload(length=9000, k=25, seed=510)
    df = bloom.DeviceFilter.from_host(wl.bf)
    gates = flag.flag_contig_gates(wl.draft, df)
    assert len(gates)
    masks = flag.polish_candidate_masks(wl.draft, df, gates)
    expect = _host_masks(wl.draft, wl.bf, gates, 25)
    assert np.array_equal(masks, expect)


def test_mask_semantics_with_non_acgt_windows():
    truth = simulate.random_genome(5000, seed=511)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=512)
    draft = draft.copy()
    draft[1200:1210] = ord("N")  # exception run -> 0xFF masks near it
    bf = simulate.truth_bf(truth, 25)
    df = bloom.DeviceFilter.from_host(bf)
    gates = flag.flag_contig_gates(draft, df)
    masks = flag.polish_candidate_masks(draft, df, gates)
    expect = _host_masks(draft, bf, gates, 25)
    # brute force marks windows containing non-ACGT as 0xFF; the device
    # path must agree wherever it claims information
    info = masks != 0xFF
    assert np.array_equal(masks[info], expect[info])
    assert np.all(expect[~info] == 0xFF) or np.all(masks[~info] == 0xFF)


def _identity_case(seed, length=20000, mode=0, mask=False, lowercase=False):
    rng = np.random.default_rng(seed)
    truth = simulate.random_genome(length, seed=seed)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=3e-3, ins_rate=1e-3, del_rate=1e-3,
        min_gap=int(rng.integers(30, 120)), seed=seed + 1,
    )
    if lowercase:
        lo = np.frombuffer(bytes(draft).lower(), dtype=np.uint8)
        pick = rng.random(len(draft)) < 0.3
        draft = np.where(pick, lo, draft).astype(np.uint8)
    bf = simulate.truth_bf(truth, 25)
    cfg = EngineConfig(k=25, hash_num=3, mode=mode, mask=mask)
    o = Oracle(bf, None, cfg)
    df = bloom.DeviceFilter.from_host(bf)
    gates = flag.flag_contig_gates(draft, df)
    masks = flag.polish_candidate_masks(draft, df, gates)
    plain = native_repair.polish_contig_native(
        o.bloom, None, cfg, "c", bytes(draft), gate_hint=gates)
    cand = native_repair.polish_contig_native(
        o.bloom, None, cfg, "c", bytes(draft), gate_hint=gates,
        gate_cand=masks)
    assert plain is not None and cand is not None
    assert cand.edited == plain.edited
    assert cand.subs == plain.subs
    assert render(cand) == render(plain)
    return draft, bf, cfg, gates, masks, plain


@pytest.mark.parametrize("seed", [520, 521, 522])
@pytest.mark.parametrize("mode", [0, 1])
def test_native_identity_with_masks(seed, mode):
    _identity_case(seed, mode=mode)


def test_native_identity_mask_mode_and_lowercase():
    _identity_case(530, mask=True, lowercase=True)


def test_segmented_identity_with_masks():
    draft, bf, cfg, gates, masks, plain = _identity_case(540, length=40000)
    seg = native_repair.polish_contig_segmented(
        Oracle(bf, None, cfg).bloom, None, cfg, "c", bytes(draft), gates,
        threads=4, gate_cand=masks)
    assert seg is not None
    assert seg.edited == plain.edited
    assert seg.subs == plain.subs
    assert render(seg) == render(plain)


def test_identity_balanced_indel_in_window():
    """Regression: a tiny high-FPR filter drives edit cascades where an
    insertion and a deletion land inside one k-window — the original
    span stays k-1 wide while the content differs from the draft.  The
    pristine check must use same-span-node, not coordinates (caught live:
    coordinate-only checks applied a stale mask at such windows)."""
    truth = simulate.random_genome(20000, seed=60)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=3e-3, ins_rate=1e-3, del_rate=1e-3, seed=61)
    host = bloom.KmerBloomFilter.zeros((1 << 16) // 8, 3, 25)
    host.insert_seq(truth)
    df = bloom.DeviceFilter.from_host(host)
    gates = flag.flag_contig_gates(draft, df)
    masks = flag.polish_candidate_masks(draft, df, gates)
    cfg = EngineConfig(k=25, hash_num=3)
    plain = native_repair.polish_contig_native(
        host, None, cfg, "c", bytes(draft), gate_hint=gates)
    cand = native_repair.polish_contig_native(
        host, None, cfg, "c", bytes(draft), gate_hint=gates, gate_cand=masks)
    assert cand.edited == plain.edited
    assert cand.subs == plain.subs
    assert render(cand) == render(plain)


def test_sharded_planes_agree_with_single_device_masks():
    """The mesh plane pass + host gather == the single-device mask path
    (and both equal brute force via test_mask_semantics_*)."""
    from ntedit_tpu.parallel import mesh as pmesh

    truth = simulate.random_genome(20000, seed=560)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=561)
    bf = simulate.truth_bf(truth, 25)
    words = bloom._pack_words(bf.data)
    df = bloom.DeviceFilter.from_host(bf)
    gates = flag.flag_contig_gates(draft, df)
    single = flag.polish_candidate_masks(draft, df, gates)
    mesh = pmesh.make_mesh(8)
    tiles, n_heads = pmesh.tile_contig(draft, 512, 25, n_tiles_multiple=8)
    pw = np.asarray(pmesh.sharded_polish_cand_planes(
        mesh, tiles, words, k=25, hash_num=bf.hash_num, nbits=bf.bits))
    planes = pw.transpose(1, 0, 2).reshape(5, -1)
    sharded = flag.cand_masks_from_planes(planes, gates)
    assert np.array_equal(single, sharded)


def test_polisher_env_wiring(monkeypatch):
    from ntedit_tpu.engine.polish import Polisher

    wl = simulate.make_workload(
        length=20000, k=25, seed=550,
        sub_rate=3e-3, ins_rate=1e-3, del_rate=1e-3,
    )
    cfg = EngineConfig(k=25, hash_num=3, threads=2)
    monkeypatch.delenv("NTEDIT_TPU_CAND", raising=False)
    base = Polisher(wl.bf, None, cfg, engine="native").polish_contig(
        "c", wl.draft)
    monkeypatch.setenv("NTEDIT_TPU_CAND", "1")
    p = Polisher(wl.bf, None, cfg, engine="native")
    assert p._polish_cand_eligible()
    on = p.polish_contig("c", wl.draft)
    assert on.edited == base.edited
    assert on.subs == base.subs
    assert render(on) == render(base)
