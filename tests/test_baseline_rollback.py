"""ntedit_baseline's insertion low-complexity rollback vs the oracle.

The scalar baseline previously approximated the reference's
accumulated-run rollback (ntedit.cpp:1312-1380); it now implements it
exactly with flat-string run bookkeeping. Pinned here on corpora BUILT to
trigger the guard — long deletions inside tandem repeats, where the engine
re-inserts the repeat word until the accumulated run reaches k and rolls
back — by byte-comparing the binary's edited output against the sequential
spec engine (oracle.py, itself byte-identical to the compiled reference
across 13 configs, tests/test_reference_binary.py).
"""

import json
import os
import subprocess

import numpy as np
import pytest

from ntedit_tpu.core import bloom
from ntedit_tpu.engine.config import EngineConfig
from ntedit_tpu.engine.oracle import Oracle
from ntedit_tpu.utils import simulate

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BINARY = os.path.join(HERE, "native", "ntedit_baseline")
K = 25

pytestmark = pytest.mark.skipif(
    not os.path.exists(BINARY), reason="native/ntedit_baseline not built"
)


def _run_pair(tmp_path, filter_seqs, draft):
    bf = bloom.KmerBloomFilter.zeros(1 << 19, 3, K)
    for s in filter_seqs:
        bf.insert_seq(np.frombuffer(bytes(s), np.uint8))
    fa = str(tmp_path / "d.fa")
    with open(fa, "w") as f:
        f.write(">c\n" + draft.tobytes().decode() + "\n")
    bfp = str(tmp_path / "t.bf")
    bf.save(bfp)
    ed = str(tmp_path / "ed.txt")
    out = json.loads(subprocess.check_output([BINARY, fa, bfp, ed]).decode())
    with open(ed, "rb") as f:
        base_edited = f.read().rstrip(b"\n")
    cfg = EngineConfig(k=K, hash_num=3)
    res = Oracle(bf, None, cfg).polish_contig("c", bytes(draft))
    return out, base_edited, res.edited


def _trigger_corpus(seed: int):
    """A junction engineered to ACCUMULATE insertions until the guard
    fires.  Draft = L + A^24 + C + R.  The filter holds L+A^60 (so the
    poly-A extension and every L window are present, and the flagged
    window A^24+C is absent) plus ONE planted k-mer, A^22 C R0 R1 —
    exactly the stride-6 verify window of the 5-base insertion "AAAAA"
    and of no shorter trial.  Every junction visit therefore inserts
    "AAAAA" with support 3 (windows at stride 0/3 are pure A^25, stride 6
    is the planted k-mer); the tail rolls through the inserted run
    (pure-A windows, clean) and re-flags at C, so the run grows 5 per
    visit until prev (= T^20, the RC of the run) reaches k with the new
    insertion and is a whole-word repeat -> rollback erases the run and
    re-seeds past the junction (ntedit.cpp:1312-1380 semantics)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    L = bases[rng.integers(0, 4, 3000)]
    R = bases[rng.integers(0, 4, 3000)]
    draft = np.concatenate([
        L, np.full(24, ord("A"), np.uint8),
        np.frombuffer(b"C", np.uint8), R,
    ])
    filter_seqs = [
        np.concatenate([L, np.full(60, ord("A"), np.uint8)]),
        np.concatenate([np.full(22, ord("A"), np.uint8),
                        np.frombuffer(b"C", np.uint8), R[:2]]),
    ]
    return filter_seqs, draft


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_engineered_rollback_matches_oracle(tmp_path, seed):
    filter_seqs, draft = _trigger_corpus(seed)
    out, base_edited, oracle_edited = _run_pair(tmp_path, filter_seqs, draft)
    assert out["n_rollback"] >= 1, f"guard did not fire: {out}"
    assert base_edited == oracle_edited
    # the rollback erases the whole accumulated run: the junction region
    # must be back to the draft bases
    assert base_edited == draft.tobytes()


@pytest.mark.parametrize("unit,missing", [
    ("A", 30), ("AT", 31), ("ACG", 28), ("AACGT", 30), ("AT", 60),
])
def test_repeat_tract_corpora_match_oracle(tmp_path, unit, missing):
    """Tandem-repeat tracts with deletions (period-aligned ones are
    k-mer-invisible; off-phase ones repair with short insertions): byte
    identity binary vs oracle either way."""
    rng = np.random.default_rng(hash((unit, missing)) % (2**32))
    bases = np.frombuffer(b"ACGT", np.uint8)
    left = bases[rng.integers(0, 4, 4000)]
    right = bases[rng.integers(0, 4, 4000)]
    tract = np.frombuffer(((unit * 200)[:120]).encode(), np.uint8)
    truth = np.concatenate([left, tract, right])
    cut = 4000 + 40
    draft = np.concatenate([truth[:cut], truth[cut + missing:]])
    _out, base_edited, oracle_edited = _run_pair(tmp_path, [truth], draft)
    assert base_edited == oracle_edited


def test_random_indel_fuzz_matches_oracle(tmp_path):
    """Random error corpora (subs + up-to-8-base indels, tighter gaps than
    the bench profile) stay byte-identical binary vs oracle."""
    for seed in range(4):
        truth = simulate.random_genome(30_000, seed=300 + seed)
        draft, _ = simulate.inject_errors(
            truth, sub_rate=3e-3, ins_rate=1e-3, del_rate=1e-3,
            max_indel=8, min_gap=40, seed=400 + seed,
        )
        out, base_edited, oracle_edited = _run_pair(tmp_path, truth, draft)
        assert base_edited == oracle_edited, f"seed {seed}"
