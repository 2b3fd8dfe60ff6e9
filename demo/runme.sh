#!/bin/bash
# Hermetic golden acceptance test (the reference demo's diff discipline,
# /root/reference/demo/runme.sh — inputs regenerated from seeds instead
# of downloaded).  Every golden under demo/ is the output of the
# UNMODIFIED reference engine (native/reference_ntedit; regenerate with
# demo/make_goldens.py), so these diffs assert byte-identity with
# bcgsc/ntEdit itself across six mode configurations.
# Run from the demo/ directory or anywhere:
#   bash demo/runme.sh [workdir]
set -euo pipefail
HERE="$(cd "$(dirname "$0")" && pwd)"
WORK="${1:-$(mktemp -d)}"
export PYTHONPATH="$HERE/..:${PYTHONPATH:-}"
cd "$WORK"

python "$HERE/make_demo.py" .
# hermetic configuration: host-side filter build + CPU backend so the
# outputs are reproducible on any machine (device and host probes are
# bit-identical — property-tested — so this pins bytes, not behaviour)
export NTEDIT_TPU_DEVICE_BUILD=0 JAX_PLATFORMS=cpu

novcf() { grep -v -e '^##source=' -e '^##fileDate=' "$1"; }

# 1. default polish through the full pipeline (histogram -> read BF ->
#    engine); also produces the filter artifacts the mode runs reuse
python -m ntedit_tpu polish --draft demo_draft.fa --reads demoReads -k 25
gunzip -kf "$HERE/golden_edited.fa.gz" -c > golden_edited.fa
diff -q ntedit_k25_edited.fa golden_edited.fa
diff -q ntedit_k25_changes.tsv "$HERE/golden_changes.tsv"
diff <(novcf ntedit_k25_variants.vcf) "$HERE/golden_variants.vcf"

BF=demoReads_k25.bf

# 2. -m 1 best-indel polish
python -m ntedit_tpu engine -f demo_draft.fa -r $BF -b mode1 -t 1 -i 5 -d 5 -m 1
diff -q mode1_changes.tsv "$HERE/golden_mode1_changes.tsv"

# 3. counting-filter coverage band (-p/-q)
python - "$HERE" <<'EOF'
import sys
sys.path.insert(0, sys.argv[1] + "/..")
from ntedit_tpu.core import bfbuild
hist = bfbuild.Histogram.load("demoReads_k25.hist", k=25)
filt, _, _ = bfbuild.build_read_filter(
    ["demoReads_1.fq.gz"], 25, cutoff=2, solid=False, fpr=0.01,
    counts=True, hist=hist)
filt.save("demoReads_k25.cbf")
EOF
python -m ntedit_tpu engine -f demo_draft.fa -r demoReads_k25.cbf -b cbf \
  -t 1 -i 5 -d 5 -p 2 -q 254
diff -q cbf_changes.tsv "$HERE/golden_cbf_changes.tsv"

# 4. -a 1 soft-masking
python -m ntedit_tpu engine -f demo_draft.fa -r $BF -b mask -t 1 -i 5 -d 5 -a 1
gunzip -kf "$HERE/golden_mask_edited.fa.gz" -c > golden_mask_edited.fa
diff -q mask_edited.fa golden_mask_edited.fa

# 5. SNV against the read filter
python -m ntedit_tpu engine -f demo_draft.fa -r $BF -b snvr -t 1 -s 1
diff <(novcf snvr_variants.vcf) "$HERE/golden_snv_reads_variants.vcf"

# 6. SNV against a genome filter (run-ntedit snv --genome flavor)
python -m ntedit_tpu make-genome-bf --genome demo_genome.fa -k 25 \
  -o demo_genome_k25.bf
python -m ntedit_tpu engine -f demo_draft.fa -r demo_genome_k25.bf -b snvg \
  -t 1 -s 1
diff <(novcf snvg_variants.vcf) "$HERE/golden_snv_genome_variants.vcf"

# 7. ClinVar-style annotation join (-l)
python -m ntedit_tpu engine -f demo_draft.fa -r $BF -b annot -t 1 -i 5 -d 5 \
  -l "$HERE/demo_annot.vcf"
diff <(novcf annot_variants.vcf) "$HERE/golden_annot_variants.vcf"
grep -q "CLNSIG=Pathogenic" annot_variants.vcf  # the join provably annotated

echo "demo OK: 9 outputs byte-identical to the reference engine's goldens"
