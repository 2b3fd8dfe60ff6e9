#!/usr/bin/env python3
"""Measure the native scalar baseline on the exact bench.py workload.

Generates the same draft/filter as bench.py (same seeds and sizing), runs
native/ntedit_baseline on it, cross-checks its edit counts against the
framework engine's, and writes native/baseline.json with the measured
bases/sec — bench.py picks that up as the vs_baseline denominator.
"""

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

from ntedit_tpu.core import bloom  # noqa: E402
from ntedit_tpu.utils import simulate  # noqa: E402

ECOLI_LEN = 4_708_041
K = 25


def main() -> None:
    binary = os.path.join(HERE, "ntedit_baseline")
    if not os.path.exists(binary):
        raise SystemExit("build first: make -C native")

    truth = simulate.random_genome(ECOLI_LEN, seed=42)
    draft, edits = simulate.inject_errors(
        truth, sub_rate=1e-3, ins_rate=1e-4, del_rate=1e-4, seed=43
    )
    nbytes = bloom.pow2_size_bytes(ECOLI_LEN, 3, 0.001)
    bf = bloom.KmerBloomFilter.zeros(nbytes, 3, K)
    bf.insert_seq(truth)

    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "draft.fa")
        with open(fa, "w") as f:
            f.write(">ecoli_sim\n")
            f.write(draft.tobytes().decode() + "\n")
        bfp = os.path.join(td, "truth.bf")
        bf.save(bfp)
        runs = [
            json.loads(subprocess.check_output([binary, fa, bfp]).decode())
            for _ in range(3)
        ]
    stats = sorted(runs, key=lambda r: r["seconds"])[1]  # median of 3
    print(json.dumps(stats))

    scale = measure_scale(binary)
    if scale is not None:
        stats["bases_per_sec_50mbp"] = scale

    with open(os.path.join(HERE, "baseline.json"), "w") as f:
        json.dump(stats, f)
    print(f"wrote native/baseline.json ({stats['bases_per_sec']:,.0f} bases/s)")


def measure_scale(binary: str):
    """Measure the scalar engine on the 50 Mbp workload bench.py's scale
    section uses (same seeds/sizing).  The filter here is 128 MiB — far
    beyond cache — so this captures the baseline's real memory-latency
    behaviour at human-chromosome scale.  The filter is built on device
    (a host build takes minutes at 50 M k-mers) and written in the plain
    btllib-like layout the baseline binary loads."""
    SCALE = 50_000_000
    truth = simulate.random_genome(SCALE, seed=52)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=1e-3, ins_rate=1e-4, del_rate=1e-4, seed=53
    )
    # same sizing as bench.py's scale section (int32 device indices cap)
    nbits = min(bloom.pow2_size_bytes(SCALE, 3, 0.001) * 8, 1 << 30)
    try:
        import jax.numpy as jnp

        from ntedit_tpu.parallel import mesh as pmesh

        # per-row device calls with ON-DEVICE OR accumulation (a batched
        # [R, 16M, 3] index tensor exceeds device memory), one final download; the
        # last row's zero padding inserts a handful of junk windows (no
        # validity mask in build_bf_words) — negligible FPR noise for a
        # throughput baseline
        import jax

        B = 1 << 24
        acc = None
        or_ = jax.jit(jnp.bitwise_or)
        for s in range(0, SCALE, B):
            row = np.zeros(B + K - 1, dtype=np.uint8)
            chunk = truth[s : min(SCALE, s + B + K - 1)]
            row[: len(chunk)] = chunk
            w = pmesh.build_bf_words(jnp.asarray(row[None]), K, 3, nbits)
            acc = w if acc is None else or_(acc, w)
        words = np.asarray(acc)
    except Exception as exc:
        print(f"scale baseline skipped: {exc}")
        return None
    bf = bloom.KmerBloomFilter(words.view(np.uint8).copy(), 3, K)
    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "draft50.fa")
        with open(fa, "w") as f:
            f.write(">chr_sim\n")
            f.write(draft.tobytes().decode() + "\n")
        bfp = os.path.join(td, "truth50.bf")
        bf.save(bfp)
        out = subprocess.check_output([binary, fa, bfp]).decode()
    stats = json.loads(out)
    print("50 Mbp:", out.strip())
    return stats["bases_per_sec"]


if __name__ == "__main__":
    main()
