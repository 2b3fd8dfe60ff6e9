"""Packed-code dense pass (the 2-bit upload path, engine.flag).

The production gate drivers upload 2-bit base codes (4x less host->device
traffic than ASCII) and hash from codes on device.  These tests pin:

* bit-identity of code-based window hashing vs the ASCII path,
* exact gate equality on ACGT-only drafts,
* the hint contract when the draft carries non-ACGT bytes: windows
  touching accepted-IUPAC bytes are superset-hinted (engines re-check
  exactly); windows touching unaccepted bytes (N, junk) are excluded
  entirely (the spec scan skips them — oracle.py:391-409),
* end-to-end polish identity with non-ACGT drafts (the hint patching
  changes no output byte).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ntedit_tpu.core import bloom, nthash as nt
from ntedit_tpu.engine import flag
from ntedit_tpu.utils import simulate, u64


@pytest.mark.parametrize("k", [17, 25, 55])
def test_window_hashes_codes_bit_identity(k):
    rng = np.random.default_rng(9)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=500)
    codes = flag._CODE_TAB[seq]
    fh_a, rh_a = nt.window_hashes(jnp.asarray(seq), k)
    fh_c, rh_c = nt.window_hashes_codes(jnp.asarray(codes), k)
    np.testing.assert_array_equal(u64.to_np(fh_c), u64.to_np(fh_a))
    np.testing.assert_array_equal(u64.to_np(rh_c), u64.to_np(rh_a))


def test_encode_packed_round_trip():
    rng = np.random.default_rng(3)
    seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=1000)
    seq[100] = ord("N")
    seq[700] = ord("R")
    k, chunk = 25, 512
    n = len(seq) - k + 1
    packed, exc = flag._encode_packed(seq, n, k, chunk)
    np.testing.assert_array_equal(exc, [100, 700])
    codes = (
        (packed[:, None].astype(np.uint32)
         >> (2 * np.arange(16, dtype=np.uint32))[None, :]) & 3
    ).reshape(-1).astype(np.uint8)
    want = flag._CODE_TAB[seq].copy()
    want[exc] = 0  # exceptions encode as 'A'
    np.testing.assert_array_equal(codes[: len(seq)], want)
    # coverage: every chunk slice [start/16, start/16 + chunk/16 + halo)
    last = ((n - 1) // chunk) * chunk
    assert len(codes) >= last + chunk + 16 * flag._halo_words(k)


def test_exception_heads_interval_union():
    n, k = 100, 25
    heads = flag._exception_heads(np.array([0, 30, 98, 99]), n, k)
    want = set(range(0, 1)) | set(range(6, 31)) | set(range(74, 100))
    assert set(heads.tolist()) == want
    assert flag._exception_heads(np.zeros(0, np.int64), n, k).size == 0


def _exact_gates(seq, df, snv=False, min_threshold=1, chunk=2048):
    """Old exact semantics via flag_chunk (kept as the spec)."""
    k = df.k
    n = len(seq) - k + 1
    pad = (-n) % chunk
    padded = np.concatenate([seq, np.zeros(pad + k - 1, np.uint8)])
    outs = []
    for start in range(0, n, chunk):
        piece = jnp.asarray(padded[start : start + chunk + k - 1])
        gate, _, _, _ = flag.flag_chunk(piece, df, k, snv, min_threshold)
        outs.append(np.asarray(gate))
    return np.flatnonzero(np.concatenate(outs)[:n]).astype(np.int64)


@pytest.mark.parametrize("snv", [False, True])
def test_packed_gates_exact_on_acgt(snv):
    truth = simulate.random_genome(30_000, seed=21)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=22)
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 17, 3, 25)
    bf.insert_seq(truth)
    df = bloom.DeviceFilter.from_host(bf)
    got = flag.flag_contig_gates(draft, df, snv=snv, chunk=4096)
    want = _exact_gates(draft, df, snv=snv, chunk=4096)
    np.testing.assert_array_equal(got, want)


def test_packed_gates_superset_with_non_acgt():
    rng = np.random.default_rng(7)
    truth = simulate.random_genome(30_000, seed=31)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=32)
    draft = draft.copy()
    pos = rng.integers(0, len(draft), size=40)
    draft[pos[:20]] = ord("N")
    draft[pos[20:]] = ord("R")
    k = 25
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 17, 3, k)
    bf.insert_seq(truth)
    df = bloom.DeviceFilter.from_host(bf)
    got = set(flag.flag_contig_gates(draft, df, chunk=4096).tolist())
    exact = set(_exact_gates(draft, df, chunk=4096).tolist())
    n = len(draft) - k + 1
    exc = np.flatnonzero(flag._CODE_TAB[draft] == 255)
    iupac_heads, bad_heads = flag._exception_hints(draft, exc, n, k)
    iupac_heads, bad_heads = set(iupac_heads.tolist()), set(bad_heads.tolist())
    # no false negatives: every exact gate is hinted
    assert exact <= got
    # the only extras are IUPAC windows; no unaccepted window ever hinted
    assert got - exact <= iupac_heads
    assert not (got & bad_heads)


def test_snv_candidates_superset_with_non_acgt():
    rng = np.random.default_rng(17)
    truth = simulate.random_genome(20_000, seed=41)
    draft, _ = simulate.inject_errors(truth, sub_rate=2e-3, seed=42)
    draft = draft.copy()
    draft[rng.integers(0, len(draft), size=10)] = ord("N")
    k = 25
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 17, 3, k)
    bf.insert_seq(truth)
    df = bloom.DeviceFilter.from_host(bf)
    got = set(flag.snv_candidate_positions(draft, df, chunk=4096).tolist())
    # exact spec: snv_candidates_chunk on the ASCII bytes
    n = len(draft) - k + 1
    pad = (-n) % 4096
    padded = np.concatenate([draft, np.zeros(pad + k - 1, np.uint8)])
    exact = []
    for start in range(0, n, 4096):
        piece = jnp.asarray(padded[start : start + 4096 + k - 1])
        words = np.asarray(flag.snv_candidates_chunk(piece, df, k))
        exact.append(flag.packed_to_positions(words, min(4096, n - start)) + start)
    exact = set(np.concatenate(exact).tolist())
    exc = np.flatnonzero(flag._CODE_TAB[draft] == 255)
    iupac_heads, bad_heads = flag._exception_hints(draft, exc, n, k)
    assert exact <= got
    assert got - exact <= set(iupac_heads.tolist())
    assert not (got & set(bad_heads.tolist()))


def test_polish_identity_with_non_acgt_draft():
    """End-to-end: packed-path polish == sequential oracle on a draft with
    N and IUPAC bytes (the superset hint must not change one output
    byte)."""
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.oracle import Oracle
    from ntedit_tpu.engine.polish import Polisher

    rng = np.random.default_rng(5)
    truth = simulate.random_genome(15_000, seed=51)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=3e-3, ins_rate=3e-4, del_rate=3e-4, seed=52
    )
    draft = draft.copy()
    draft[rng.integers(0, len(draft), size=12)] = ord("N")
    draft[rng.integers(0, len(draft), size=6)] = ord("R")
    k = 25
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 17, 3, k)
    bf.insert_seq(truth)
    cfg = EngineConfig(k=k, hash_num=bf.hash_num)
    want = Oracle(bf, None, cfg).polish_contig("c", bytes(draft))
    got = Polisher(bf, cfg=cfg).polish_contig("c", draft)
    assert got.edited == want.edited
    assert got.subs == want.subs


def test_iter_gate_chunks_equals_one_shot():
    """Streamed per-chunk gates (the pipelined feed) == the one-shot gate
    pass, including tail-chunk padding and frontier accounting."""
    import numpy as np

    from ntedit_tpu.core import bloom
    from ntedit_tpu.engine import flag
    from ntedit_tpu.utils import simulate

    truth = simulate.random_genome(20000, seed=40)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=41)
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 15, 3, 25)
    bf.insert_seq(truth)
    df = bloom.DeviceFilter.from_host(bf)
    want = flag.flag_contig_gates(draft, df, chunk=4096)
    got = []
    last_frontier = 0
    for frontier, g in flag.iter_gate_chunks(draft, df, chunk=4096):
        assert frontier > last_frontier
        assert ((g >= last_frontier) & (g < frontier)).all()
        last_frontier = frontier
        got.append(g)
    np.testing.assert_array_equal(np.concatenate(got), want)
    assert last_frontier == len(draft) - 24


def _host_gates(draft, bf, k, snv):
    """numpy reference of the dense gate set (nthash_ref hashes probed
    against the host filter): polish gates every fully-accepted window
    whose k-mer is absent; SNV gates every fully-accepted window where
    some allowed alternate tail base makes the k-mer present."""
    from ntedit_tpu.core import nthash_ref as ref
    from ntedit_tpu.engine.config import ACCEPTED

    acc = np.zeros(256, bool)
    for c in ACCEPTED:
        acc[c] = acc[c + 32] = True
    ok = acc[draft].astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(ok)])
    valid = (cs[k:] - cs[:-k]) == k
    n = len(draft) - k + 1
    heads = np.flatnonzero(valid)
    if not snv:
        fh, rh = ref.all_window_hashes(draft, k)
        present = bf.contains_base(ref.canonical(fh, rh))
        return heads[~present[heads]]
    cand = np.zeros(n, bool)
    tails = draft[heads + k - 1] & 0xDF
    acgt = np.isin(tails, np.frombuffer(b"ACGT", np.uint8))
    windows = np.lib.stride_tricks.sliding_window_view(draft, k)[heads]
    for b in b"ACGT":
        alt = windows.copy()
        alt[:, -1] = b  # the head's k-mer with its last base replaced
        fh, rh = ref.all_window_hashes(alt.reshape(-1), k)
        rows = np.arange(len(heads)) * k
        present = bf.contains_base(ref.canonical(fh[rows], rh[rows]))
        cand[heads] |= present & (~acgt | (tails != b))
    return np.flatnonzero(cand)


@pytest.mark.parametrize("snv", [False, True], ids=["polish", "snv"])
@pytest.mark.parametrize("k", [25, 17])
def test_dense_gates_match_host_reference(k, snv):
    """The XLA dense pass (flag_contig_gates / snv_candidate_positions)
    equals the numpy host reference on a draft sprinkled with IUPAC and
    N bytes: windows with an unaccepted byte never gate, windows with an
    accepted IUPAC byte may only be superset-hinted."""
    rng = np.random.default_rng(5)
    truth = simulate.random_genome(40_000, seed=11)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=2e-3, ins_rate=2e-4, del_rate=2e-4, seed=12
    )
    pos = rng.integers(0, len(draft), size=30)
    draft = draft.copy()
    draft[pos[:15]] = ord("N")
    draft[pos[15:]] = ord("R")
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 18, 3, k)
    bf.insert_seq(truth)
    df = bloom.DeviceFilter.from_host(bf)
    if snv:
        got = flag.snv_candidate_positions(draft, df, chunk=4096)
    else:
        got = flag.flag_contig_gates(draft, df, chunk=4096)
    want = _host_gates(draft, bf, k, snv)
    n = len(draft) - k + 1
    iupac = np.zeros(n, bool)
    for p in pos[15:]:
        iupac[max(0, p - k + 1) : p + 1] = True
    bad = np.zeros(n, bool)
    for p in pos[:15]:
        bad[max(0, p - k + 1) : p + 1] = True
    iupac &= ~bad
    got_set = np.zeros(n, bool)
    got_set[got] = True
    want_set = np.zeros(n, bool)
    want_set[want] = True
    assert not (got_set & bad).any()
    # exact away from IUPAC windows; superset (never a miss) at them
    np.testing.assert_array_equal(got_set[~iupac], want_set[~iupac])
    assert (got_set[iupac] | ~want_set[iupac]).all()
    assert want_set.sum() > 100
