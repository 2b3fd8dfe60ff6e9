"""REAL-sequence byte-identity: the reference demo's actual E. coli
draft (4.6 Mbp of U00096.3-derived sequence) polished by the framework
and by the UNMODIFIED reference binary, outputs byte-diffed.

Uniform-random corpora have almost no repeats or low-complexity runs, so
the KMP insertion-rollback guard (/root/reference/ntedit.cpp:1312-1380)
and dense indel-cascade paths are only exercised by targeted unit fuzz.
This test uses the real genome: the reference
demo draft as TRUTH, errors injected at the demo's documented rates
(README.md:333), the filter built from its k-mers — then both engines
run with identical flags and all three outputs must match byte for byte.
"""

import os
import subprocess

import numpy as np
import pytest

from ntedit_tpu import cli
from ntedit_tpu.core import bloom
from ntedit_tpu.io import fastx
from ntedit_tpu.utils import simulate

REAL_ECOLI = "/root/reference/demo/ecoliWithMismatches001Indels0001.fa.gz"
REF_BIN = os.path.join(
    os.path.dirname(__file__), os.pardir, "native", "reference_ntedit")

pytestmark = [
    pytest.mark.skipif(not os.path.exists(REAL_ECOLI),
                       reason="reference demo draft not present"),
    pytest.mark.skipif(not os.path.exists(REF_BIN),
                       reason="reference binary not built"),
]


def _normalize_vcf(path):
    with open(path) as f:
        return [ln for ln in f
                if not ln.startswith("##source=")
                and not ln.startswith("##fileDate=")]


@pytest.mark.parametrize("slice_mbp,flags", [
    # full real sequence, default polish (subs + indels, KMP rollback in
    # real low-complexity context)
    (None, ["-i", "5", "-d", "5"]),
    # 1.5 Mbp slice, denser indels + mode 1 (best-edit arbitration)
    (1_500_000, ["-i", "4", "-d", "5", "-m", "1"]),
])
def test_real_ecoli_byte_identity(tmp_path, monkeypatch, slice_mbp, flags):
    monkeypatch.chdir(tmp_path)
    recs = list(fastx.read_fastx(REAL_ECOLI))
    truth = np.concatenate([r.seq for r in recs])
    if slice_mbp:
        truth = truth[:slice_mbp]
    draft, injected = simulate.inject_errors(
        truth, sub_rate=1e-3, ins_rate=1e-4, del_rate=1e-4, seed=99)
    assert len(injected) > 100
    nbytes = bloom.pow2_size_bytes(len(truth), 3, 0.001)
    pbf = bloom.KmerBloomFilter.zeros(nbytes, 3, 25)
    pbf.insert_seq(truth)
    with open(tmp_path / "d.fa", "w") as f:
        f.write(">U00096.3_draft\n" + draft.tobytes().decode() + "\n")
    pbf.save(str(tmp_path / "t.bf"))

    res = subprocess.run(
        [os.path.abspath(REF_BIN), "-f", "d.fa", "-r", "t.bf",
         "-b", "refout", "-t", "1"] + flags,
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    cli.main(["engine", "-f", "d.fa", "-r", "t.bf", "-b", "ours",
              "-t", "1"] + flags)

    for suffix in ("_edited.fa", "_changes.tsv"):
        a = (tmp_path / f"refout{suffix}").read_bytes()
        b = (tmp_path / f"ours{suffix}").read_bytes()
        assert a == b, f"{suffix} differs on REAL sequence"
    assert _normalize_vcf(tmp_path / "refout_variants.vcf") == _normalize_vcf(
        tmp_path / "ours_variants.vcf")
