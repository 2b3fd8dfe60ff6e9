#!/usr/bin/env python3
"""Regenerate the demo goldens FROM THE REFERENCE BINARY.

Every golden under demo/ is the output of the unmodified bcgsc/ntEdit
v2.1.1 engine (native/reference_ntedit, ntedit.cpp compiled against the
btllib-compat shim — see tests/test_reference_binary.py) run on the
hermetic demo inputs, across six mode configurations:

  polish   default mode-0 polish          (golden_edited.fa.gz, golden_changes.tsv,
                                           golden_variants.vcf)
  mode1    -m 1 best-indel polish         (golden_mode1_changes.tsv)
  cbf      counting filter -p 2 -q 254    (golden_cbf_changes.tsv)
  mask     -a 1 soft-masking              (golden_mask_edited.fa.gz)
  snvr     SNV vs the read filter (-s 1)  (golden_snv_reads_variants.vcf)
  snvg     SNV vs a genome filter (-s 1)  (golden_snv_genome_variants.vcf)
  annot    -l annotation join             (golden_annot_variants.vcf)

demo/runme.sh then diffs the FRAMEWORK's outputs against these — the
acceptance bar is byte-identity with the reference engine itself, not
with a prior run of this code.  VCF goldens are stored with the
##source/##fileDate header lines stripped (program name / clock differ
legitimately).

Usage:  make -C native reference_ntedit && python demo/make_goldens.py
"""

import gzip
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
REF_BIN = os.path.join(REPO, "native", "reference_ntedit")


def normalize_vcf(path: str) -> bytes:
    with open(path, "rb") as f:
        return b"".join(
            ln for ln in f
            if not ln.startswith(b"##source=")
            and not ln.startswith(b"##fileDate=")
        )


def run_reference(args, cwd):
    res = subprocess.run(
        [REF_BIN] + args, cwd=cwd, capture_output=True, text=True, timeout=600,
    )
    if res.returncode != 0:
        raise SystemExit(f"reference_ntedit failed:\n{res.stdout}\n{res.stderr}")


def main() -> None:
    if not os.path.exists(REF_BIN):
        raise SystemExit("build the reference first: make -C native reference_ntedit")
    os.environ.setdefault("NTEDIT_TPU_DEVICE_BUILD", "0")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    from ntedit_tpu import cli
    from ntedit_tpu.core import bfbuild

    work = tempfile.mkdtemp(prefix="ntedit_goldens_")
    os.chdir(work)
    subprocess.run(
        [sys.executable, os.path.join(HERE, "make_demo.py"), "."], check=True,
    )

    # pipeline artifacts exactly as demo/runme.sh produces them: the BF the
    # engine consumes is the framework pipeline's own (reference and
    # framework then probe the identical artifact)
    cli.main(["polish", "--draft", "demo_draft.fa", "--reads", "demoReads",
              "-k", "25"])
    bf = "demoReads_k25.bf"

    # CBF artifact for the coverage-band mode
    hist = bfbuild.Histogram.load("demoReads_k25.hist", k=25)
    filt, _, _ = bfbuild.build_read_filter(
        ["demoReads_1.fq.gz"], 25, cutoff=2, solid=False, fpr=0.01,
        counts=True, hist=hist,
    )
    filt.save("demoReads_k25.cbf")

    # genome filter for the SNV --genome flavor (the truth genome plays the
    # comparison assembly)
    cli.main(["make-genome-bf", "--genome", "demo_genome.fa", "-k", "25",
              "-o", "demo_genome_k25.bf"])

    # annotation input: entries keyed to real demo variants (first rows of
    # the reference's own polish VCF), committed as a demo input so the
    # -l join provably annotates (^info appends, writers.py:43-53)
    run_reference(["-f", "demo_draft.fa", "-r", bf, "-b", "ref_pre",
                   "-t", "1", "-i", "5", "-d", "5"], work)
    ann = ["##fileformat=VCFv4.2",
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    with open("ref_pre_variants.vcf") as f:
        rows = [ln.split("\t") for ln in f if not ln.startswith("#")]
    for c in rows[:5]:
        ann.append(f"{c[0]}\t{c[1]}\t.\t{c[3]}\t{c[4]}\t.\t.\t"
                   f"CLNSIG=Pathogenic;RS={c[1]}")
    with open(os.path.join(HERE, "demo_annot.vcf"), "w") as f:
        f.write("\n".join(ann) + "\n")

    configs = [
        ("polish", bf, ["-i", "5", "-d", "5"]),
        ("mode1", bf, ["-i", "5", "-d", "5", "-m", "1"]),
        ("cbf", "demoReads_k25.cbf", ["-i", "5", "-d", "5", "-p", "2", "-q", "254"]),
        ("mask", bf, ["-i", "5", "-d", "5", "-a", "1"]),
        ("snvr", bf, ["-s", "1"]),
        ("snvg", "demo_genome_k25.bf", ["-s", "1"]),
        ("annot", bf, ["-i", "5", "-d", "5", "-l",
                       os.path.join(HERE, "demo_annot.vcf")]),
    ]
    for name, filt_path, flags in configs:
        run_reference(
            ["-f", "demo_draft.fa", "-r", filt_path, "-b", f"ref_{name}",
             "-t", "1"] + flags, work,
        )

    # the default-polish goldens keep their original names (runme.sh
    # compat); every golden is reference-engine output from here on
    with open("ref_polish_edited.fa", "rb") as f, \
         gzip.GzipFile(os.path.join(HERE, "golden_edited.fa.gz"), "wb",
                       mtime=0) as g:
        g.write(f.read())
    shutil.copy("ref_polish_changes.tsv", os.path.join(HERE, "golden_changes.tsv"))
    with open(os.path.join(HERE, "golden_variants.vcf"), "wb") as f:
        f.write(normalize_vcf("ref_polish_variants.vcf"))

    shutil.copy("ref_mode1_changes.tsv", os.path.join(HERE, "golden_mode1_changes.tsv"))
    shutil.copy("ref_cbf_changes.tsv", os.path.join(HERE, "golden_cbf_changes.tsv"))
    with open("ref_mask_edited.fa", "rb") as f, \
         gzip.GzipFile(os.path.join(HERE, "golden_mask_edited.fa.gz"), "wb",
                       mtime=0) as g:
        g.write(f.read())
    for name, out in [("snvr", "golden_snv_reads_variants.vcf"),
                      ("snvg", "golden_snv_genome_variants.vcf"),
                      ("annot", "golden_annot_variants.vcf")]:
        with open(os.path.join(HERE, out), "wb") as f:
            f.write(normalize_vcf(f"ref_{name}_variants.vcf"))
    print(f"goldens regenerated from the reference binary in {HERE} "
          f"(work: {work})")


if __name__ == "__main__":
    main()
