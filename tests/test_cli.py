"""CLI layer: pipeline subcommands, stage caching, engine parity."""

import gzip
import os

import numpy as np
import pytest

from ntedit_tpu import cli
from ntedit_tpu.core import bfbuild, bloom
from ntedit_tpu.io import fastx
from ntedit_tpu.utils import simulate


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _make_inputs(tmp_path, L=20000, seed=200, coverage=40):
    truth = simulate.random_genome(L, seed=seed)
    draft, injected = simulate.inject_errors(truth, sub_rate=1e-3, seed=seed + 1)
    fastx.write_fasta(str(tmp_path / "draft.fa"), [("ctg1 assembly", draft.tobytes())])
    rng = np.random.default_rng(seed + 2)
    n_reads = L * coverage // 100
    with gzip.open(tmp_path / "myReads_1.fq.gz", "wt") as f:
        for i in range(n_reads):
            s = rng.integers(0, L - 100)
            r = truth[s : s + 100]
            f.write(f"@r{i}\n{r.tobytes().decode()}\n+\n{'I' * 100}\n")
    return truth, draft, injected


def test_polish_pipeline_end_to_end(workdir, capsys):
    truth, draft, injected = _make_inputs(workdir)
    cli.main(["polish", "--draft", "draft.fa", "--reads", "myReads", "-k", "25"])
    out = capsys.readouterr().out
    assert "Done ntEdit!" in out
    assert os.path.exists("myReads_k25.hist")
    assert os.path.exists("myReads_k25.bf")
    recs = list(fastx.read_fastx("ntedit_k25_edited.fa"))
    assert recs[0].header == "ctg1 assembly"
    assert recs[0].seq.tobytes() == truth.tobytes()
    tsv = open("ntedit_k25_changes.tsv").read().splitlines()
    assert tsv[0].startswith("ID\tbpPosition+1")
    assert len(tsv) > 1
    vcf = open("ntedit_k25_variants.vcf").read()
    assert "##fileformat=VCFv4.2" in vcf

    # second run: everything cached
    cli.main(["polish", "--draft", "draft.fa", "--reads", "myReads", "-k", "25"])
    out2 = capsys.readouterr().out
    assert out2.count("[cached]") == 3

    # --force reruns
    cli.main(["polish", "--draft", "draft.fa", "--reads", "myReads", "-k", "25",
              "--force", "-n"])
    out3 = capsys.readouterr().out
    assert out3.count("[would run]") == 3


def test_polish_dry_run_runs_nothing(workdir, capsys):
    _make_inputs(workdir)
    cli.main(["polish", "--draft", "draft.fa", "--reads", "myReads", "-k", "25",
              "--dry-run"])
    out = capsys.readouterr().out
    assert out.count("[would run]") == 3
    assert not os.path.exists("myReads_k25.bf")


def test_engine_direct_and_prefix_default(workdir, capsys):
    truth, draft, _ = _make_inputs(workdir, L=8000, seed=210)
    bf = simulate.truth_bf(truth, 25)
    bf.save("reads.bf")
    cli.main(["engine", "-r", "reads.bf", "-f", "draft.fa"])
    # auto-composed prefix (ntedit.cpp:2494-2501)
    prefix = "draft.fa_k25_z100_rreads.bf_i5_d5_m0"
    assert os.path.exists(prefix + "_edited.fa")
    recs = list(fastx.read_fastx(prefix + "_edited.fa"))
    assert recs[0].seq.tobytes() == truth.tobytes()


def test_engine_rejects_mismatched_reject_bf(workdir):
    truth, _, _ = _make_inputs(workdir, L=6000, seed=220)
    simulate.truth_bf(truth, 25).save("a.bf")
    simulate.truth_bf(truth, 31).save("b31.bf")
    with pytest.raises(SystemExit):
        cli.main(["engine", "-r", "a.bf", "-f", "draft.fa", "-e", "b31.bf"])


def test_snv_reads_flavor(workdir):
    truth = simulate.random_genome(4000, seed=230)
    p = 2000
    variant = truth.copy()
    variant[p] = ord("A") if truth[p] != ord("A") else ord("C")
    fastx.write_fasta("ref.fa", [("chr1", truth.tobytes())])
    rng = np.random.default_rng(231)
    with open("vreads_1.fq", "w") as f:
        i = 0
        for source in (truth, variant):
            for _ in range(800):
                s = rng.integers(0, len(truth) - 100)
                r = source[s : s + 100]
                f.write(f"@r{i}\n{r.tobytes().decode()}\n+\n{'I' * 100}\n")
                i += 1
    cli.main(["snv", "--reference", "ref.fa", "--reads", "vreads", "-k", "25"])
    vcf = [l for l in open("vreads_ntedit_k25_variants.vcf") if not l.startswith("#")]
    assert any(l.split("\t")[1] == str(p + 1) for l in vcf)


def test_snv_requires_exactly_one_source(workdir):
    with pytest.raises(SystemExit):
        cli.main(["snv", "--reference", "x.fa", "-k", "25"])
    with pytest.raises(SystemExit):
        cli.main(["snv", "--reference", "x.fa", "--reads", "r", "--genome", "g.fa",
                  "-k", "25"])


def test_snv_genome_flavor(workdir):
    truth = simulate.random_genome(5000, seed=240)
    p = 2500
    other = truth.copy()
    other[p] = ord("A") if truth[p] != ord("A") else ord("C")
    fastx.write_fasta("ref.fa", [("chr1", truth.tobytes())])
    fastx.write_fasta("donor.fa", [("donor", other.tobytes())])
    cli.main(["snv", "--reference", "ref.fa", "--genome", "donor.fa", "-k", "25"])
    assert os.path.exists("donor_k25.bf")
    vcf = [l for l in open("donor_ntedit_k25_variants.vcf") if not l.startswith("#")]
    assert any(l.split("\t")[1] == str(p + 1) for l in vcf)


def test_make_genome_bf_cli(workdir):
    truth = simulate.random_genome(3000, seed=250)
    fastx.write_fasta("g.fa", [("g", truth.tobytes())])
    cli.main(["make-genome-bf", "--genome", "g.fa", "-k", "25", "-o", "out.bf"])
    bf = bloom.KmerBloomFilter.load("out.bf")
    assert bf.k == 25
    assert bf.bytes == bloom.bf_size_bytes(3000, 3, 0.01)
    from ntedit_tpu.core import nthash_ref as nh
    h = bfbuild.valid_canonical_hashes(truth, 25)
    assert bf.contains_hashes(nh.extend_hashes_vec(h, 25, 3)).all()


def test_clinvar_annotation_flag(workdir):
    truth, draft, injected = _make_inputs(workdir, L=6000, seed=260)
    bf = simulate.truth_bf(truth, 25)
    bf.save("r.bf")
    # annotate the first injected substitution with a ClinVar-style INFO
    subs = [e for e in injected if e[1] == "sub"]
    pos, _, detail = subs[0]
    frm, to = detail.split(">")
    # draft coordinate == truth coordinate for the first error
    with open("clin.vcf", "w") as f:
        f.write(
            f"ctg1 assembly\t{pos + 1}\t.\t{to}\t{frm}\t.\tPASS\tCLNSIG=Benign_stuff\n"
        )
    # malformed: too few columns -> line must be skipped, not crash
    with open("clin.vcf", "a") as f:
        f.write("junk\tline\n")
    cli.main(["engine", "-r", "r.bf", "-f", "draft.fa", "-b", "ann",
              "-l", "clin.vcf"])
    vcf = open("ann_variants.vcf").read()
    assert "^NA" in vcf  # un-annotated alleles marked NA


def test_cli_version_and_help(capsys):
    with pytest.raises(SystemExit):
        cli.main(["polish", "--version"])
    capsys.readouterr()
    with pytest.raises(SystemExit):
        cli.main([])
    assert "polish" in capsys.readouterr().out


def test_threads_byte_identical_multi_contig(workdir):
    """-t 4 polish of a multi-contig draft is byte-identical to -t 1
    (deterministic input-order output — FIDELITY #6; the reference is
    completion-order nondeterministic at t>1, ntedit.cpp:2213-2250)."""
    rng = np.random.default_rng(900)
    contigs = []
    pieces = []
    for c in range(3):
        truth = simulate.random_genome(12000 + 1000 * c, seed=901 + c)
        draft, _ = simulate.inject_errors(
            truth, sub_rate=2e-3, ins_rate=5e-4, del_rate=5e-4, seed=905 + c
        )
        contigs.append(truth)
        pieces.append((f"ctg{c} test", draft.tobytes()))
    fastx.write_fasta("draft.fa", pieces)
    bf = bloom.KmerBloomFilter.zeros(1 << 18, 3, 25)
    for t in contigs:
        bf.insert_seq(t)
    bf.save("reads.bf")

    outs = {}
    for t in (1, 4):
        cli.main(["engine", "-r", "reads.bf", "-f", "draft.fa",
                  "-b", f"out_t{t}", "-t", str(t)])
        blob = b""
        for suffix in ("_edited.fa", "_changes.tsv", "_variants.vcf"):
            with open(f"out_t{t}{suffix}", "rb") as f:
                data = f.read()
            if suffix == "_variants.vcf":
                # strip the fileDate header line (timestamp)
                data = b"\n".join(
                    l for l in data.split(b"\n") if not l.startswith(b"##fileDate")
                )
            blob += data + b"\x00"
        outs[t] = blob
    assert outs[1] == outs[4]


def test_estimated_draft_bytes_gz(tmp_path):
    """spill='auto' must see through gzip: a compressed multi-hundred-MB
    draft is exactly the expensive-restart case.  The .gz
    estimate reads the gzip trailer ISIZE; a wrapped/absent trailer falls
    back to 4x the compressed size."""
    import gzip

    from ntedit_tpu.cli import _estimated_draft_bytes

    raw = tmp_path / "d.fa"
    raw.write_bytes(b">c\n" + b"ACGT" * 1000 + b"\n")
    assert _estimated_draft_bytes(str(raw)) == raw.stat().st_size

    gz = tmp_path / "d.fa.gz"
    with gzip.open(gz, "wb") as f:
        f.write(b">c\n" + b"ACGT" * 100000 + b"\n")
    est = _estimated_draft_bytes(str(gz))
    assert est == 400004  # exact ISIZE of the uncompressed stream

    # corrupt trailer (ISIZE smaller than the compressed stream): 4x fallback
    data = gz.read_bytes()
    bad = tmp_path / "bad.fa.gz"
    bad.write_bytes(data[:-4] + b"\x01\x00\x00\x00")
    assert _estimated_draft_bytes(str(bad)) == bad.stat().st_size * 4
