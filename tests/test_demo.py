"""Hermetic golden acceptance test (the reference demo's diff discipline,
/root/reference/demo/runme.sh:8-10 — inputs regenerated from seeds,
outputs byte-compared against committed goldens)."""

import gzip
import os
import subprocess
import sys

import pytest

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demo")


@pytest.mark.skipif(not os.path.isdir(DEMO), reason="demo/ not present")
def test_demo_golden_outputs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("NTEDIT_TPU_DEVICE_BUILD", "0")  # hermetic host build
    subprocess.run(
        [sys.executable, os.path.join(DEMO, "make_demo.py"), "."],
        check=True, capture_output=True,
    )
    from ntedit_tpu import cli

    cli.main(["polish", "--draft", "demo_draft.fa", "--reads", "demoReads",
              "-k", "25"])
    with open("ntedit_k25_changes.tsv", "rb") as f:
        got_tsv = f.read()
    with open(os.path.join(DEMO, "golden_changes.tsv"), "rb") as f:
        want_tsv = f.read()
    assert got_tsv == want_tsv, "changes.tsv differs from the golden"
    with open("ntedit_k25_edited.fa", "rb") as f:
        got_fa = f.read()
    with gzip.open(os.path.join(DEMO, "golden_edited.fa.gz"), "rb") as f:
        want_fa = f.read()
    assert got_fa == want_fa, "edited.fa differs from the golden"


def test_demo_all_modes_against_reference_goldens(tmp_path):
    """bash demo/runme.sh — every mode (polish, -m 1, CBF -p/-q, -a 1,
    SNV vs reads, SNV vs genome, -l annotation) byte-diffed against
    goldens produced by the UNMODIFIED reference engine
    (demo/make_goldens.py), 9 golden files total."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        ["bash", os.path.join(DEMO, "runme.sh"), str(tmp_path)],
        capture_output=True, text=True, timeout=800, env=env,
    )
    assert res.returncode == 0, f"runme.sh failed:\n{res.stdout}\n{res.stderr}"
    assert "9 outputs byte-identical" in res.stdout
