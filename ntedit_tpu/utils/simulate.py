"""Synthetic workloads: genomes, error-injected drafts, exact-truth Bloom
filters.

The reference validates against an E. coli demo (draft with ~0.001
substitution and ~0.0001 indel rates, BF from 100x simulated reads,
README.md:333).  That data needs network access; these generators produce
the same *shape* of workload hermetically: a random genome, a draft with
injected errors, and a Bloom filter containing exactly the truth k-mers
(the infinite-coverage limit of the read-derived filter).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ntedit_tpu.core import bloom

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class SimWorkload:
    truth: np.ndarray        # uint8 ASCII
    draft: np.ndarray        # uint8 ASCII with injected errors
    edits: list              # (truth_pos, kind, detail) ground truth
    bf: bloom.KmerBloomFilter


def random_genome(length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return BASES[rng.integers(0, 4, size=length)]


def inject_errors(
    truth: np.ndarray,
    sub_rate: float = 1e-3,
    ins_rate: float = 1e-4,
    del_rate: float = 1e-4,
    max_indel: int = 3,
    min_gap: int = 60,
    seed: int = 1,
):
    """Inject isolated errors (>= min_gap apart so each is independently
    correctable — matches the demo's sparse error profile)."""
    rng = np.random.default_rng(seed)
    L = len(truth)
    n_err = int(L * (sub_rate + ins_rate + del_rate))
    if L > 300_000_000:
        # human-scale fast path: rng.choice without replacement permutes
        # all L positions (minutes + a 24 GB arange at 3 Gbp); sampled
        # integers + dedupe give the same isolated-error profile after
        # the min_gap filter below
        pos = np.unique(rng.integers(min_gap, L - min_gap, size=n_err))
    else:
        pos = np.sort(rng.choice(np.arange(min_gap, L - min_gap), size=n_err, replace=False))
    keep = np.concatenate([[True], np.diff(pos) >= min_gap])
    pos = pos[keep]
    kinds = rng.choice(
        ["sub", "ins", "del"],
        size=len(pos),
        p=np.array([sub_rate, ins_rate, del_rate]) / (sub_rate + ins_rate + del_rate),
    )
    out = []
    edits = []
    prev = 0
    for p, kind in zip(pos, kinds):
        out.append(truth[prev:p])
        if kind == "sub":
            wrong = BASES[(np.where(BASES == truth[p])[0][0] + rng.integers(1, 4)) % 4]
            out.append(np.array([wrong], dtype=np.uint8))
            edits.append((int(p), "sub", chr(truth[p]) + ">" + chr(wrong)))
            prev = p + 1
        elif kind == "ins":
            # draft has EXTRA bases -> polisher must delete them
            n = int(rng.integers(1, max_indel + 1))
            extra = BASES[rng.integers(0, 4, size=n)]
            out.append(extra)
            out.append(truth[p : p + 1])
            edits.append((int(p), "extra", extra.tobytes().decode()))
            prev = p + 1
        else:
            # draft MISSES bases -> polisher must insert them
            n = int(rng.integers(1, max_indel + 1))
            edits.append((int(p), "missing", truth[p : p + n].tobytes().decode()))
            prev = p + n
    out.append(truth[prev:])
    return np.concatenate(out), edits


def write_reads_fastq(path: str, genome: np.ndarray, coverage: float = 30.0,
                      read_len: int = 150, err_rate: float = 0.01,
                      seed: int = 3) -> int:
    """Shotgun reads of ``genome`` as uncompressed FASTQ: uniform start
    positions, both strands, independent substitution errors at
    ``err_rate`` per base.  Returns the number of reads written."""
    rng = np.random.default_rng(seed)
    n = int(len(genome) * coverage / read_len)
    starts = rng.integers(0, len(genome) - read_len + 1, size=n)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    rc = rng.random(n) < 0.5
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    reads[rc] = comp[reads[rc, ::-1]]
    err = rng.random(reads.shape) < err_rate
    shift = rng.integers(1, 4, size=int(err.sum()))
    code = np.searchsorted(BASES, reads[err])
    reads[err] = BASES[(code + shift) % 4]
    qual = b"I" * read_len
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), qual))
    return n


def truth_bf(truth: np.ndarray, k: int, hash_num: int = 3, fpr: float = 0.001) -> bloom.KmerBloomFilter:
    n_kmers = max(1, len(truth) - k + 1)
    bf = bloom.KmerBloomFilter.zeros(max(64, bloom.bf_size_bytes(n_kmers, hash_num, fpr)), hash_num, k)
    bf.insert_seq(truth)
    return bf


def make_workload(length=20000, k=25, seed=0, **err_kw) -> SimWorkload:
    truth = random_genome(length, seed)
    draft, edits = inject_errors(truth, seed=seed + 1, **err_kw)
    return SimWorkload(truth, draft, edits, truth_bf(truth, k))
