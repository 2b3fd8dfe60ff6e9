"""Multi-host runtime: process initialization and record gathering.

The reference has no distributed layer (OpenMP shared memory only,
/root/reference/ntedit.cpp:2213; SURVEY.md §5.8).  The equivalent here
is the JAX multi-controller runtime: every process runs the same
program, `initialize()` joins the cluster, and the existing mesh code
(`parallel.mesh`) shards over the global device set unchanged —
`Mesh(jax.devices(), ...)` simply sees all devices.

Multi-host data flow for a polish run:

1. every process reads its FASTQ shard and builds a partial filter;
   `mesh.sharded_bf_build`'s ring-OR (or the CBF psum) merges across all
   devices — device collectives, no host traffic;
2. the dense flag pass shards contig windows over the global mesh
   (`mesh.sharded_polish`); gate words land sharded, each process reads
   its addressable slice;
3. sparse repair runs on each process for the contig ranges it owns
   (segment cuts at quiet gaps make ranges independent — the same
   argument as thread segmentation, native_repair._gap_margin);
4. `gather_records` allgathers the per-process edit records so rank 0
   writes the merged _edited.fa/_changes.tsv/_variants.vcf in input
   order (deterministic, FIDELITY #6).

Single-process every helper degrades to the identity; the collectives
themselves are exercised on the virtual 8-device CPU mesh
(tests/test_parallel.py), and two real processes run the CLI in
tests/test_multihost.py.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import jax
import numpy as np


def initialize_from_env() -> None:
    """Join the multi-controller cluster from environment configuration —
    the CLI calls this before any other JAX use (ntedit_tpu.cli.main).

    Launch every rank with:

        NTEDIT_TPU_COORDINATOR=host:port
        NTEDIT_TPU_NUM_PROCESSES=N
        NTEDIT_TPU_PROCESS_ID=i        python -m ntedit_tpu ...

    Several ranks on one multi-GPU host each get their own card from the
    launcher (CUDA_VISIBLE_DEVICES=i per rank), so no rank reserves
    memory on another rank's card.  Where a cluster manager lets JAX
    auto-detect the cluster, set NTEDIT_TPU_DISTRIBUTED=1 instead.
    Unset environment -> single-process no-op."""
    if os.environ.get("NTEDIT_TPU_DISTRIBUTED") == "1":
        jax.distributed.initialize()
        return
    coord = os.environ.get("NTEDIT_TPU_COORDINATOR")
    if not coord:
        return
    initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["NTEDIT_TPU_NUM_PROCESSES"]),
        process_id=int(os.environ["NTEDIT_TPU_PROCESS_ID"]),
    )


def active() -> bool:
    """True when this run spans more than one process."""
    return jax.process_count() > 1


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the JAX multi-controller cluster.

    Pass the arguments explicitly (JAX auto-detects them only under a
    cluster manager).  No-op when already initialized or when running
    single-process with no coordinator configured.

    Must be the first JAX call in the process: anything that initializes
    the XLA backend first (even jax.process_count()) makes the
    multi-controller join impossible, so this function inspects only its
    arguments before handing off to jax.distributed."""
    if coordinator_address is None and num_processes in (None, 1):
        return  # single-process run: nothing to join
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as exc:
        if "already" in str(exc).lower():
            return  # idempotent re-entry
        raise


def process_slice(n_items: int) -> slice:
    """The contiguous range of work items this process owns (contigs or
    contig windows), splitting evenly in input order so the merged output
    is deterministic."""
    p = jax.process_count()
    i = jax.process_index()
    per = -(-n_items // p)
    return slice(i * per, min(n_items, (i + 1) * per))


def gather_records(local_blobs: list) -> list:
    """Allgather per-process record lists; returns the concatenation in
    process order (rank 0's records first).  Identity single-process.

    Records are arbitrary Python objects (SubRec lists, rope node streams);
    they travel pickled through the host allgather — record volume is tiny
    (edits, not sequence data)."""
    if jax.process_count() == 1:
        return list(local_blobs)
    from jax.experimental import multihost_utils

    payload = np.frombuffer(pickle.dumps(local_blobs), dtype=np.uint8)
    # pad to the global max length; exchange lengths first
    n = np.asarray([payload.size], dtype=np.int64)
    all_n = multihost_utils.process_allgather(n)
    m = int(all_n.max())
    padded = np.zeros(m, dtype=np.uint8)
    padded[: payload.size] = payload
    gathered = multihost_utils.process_allgather(padded)
    out = []
    for i in range(jax.process_count()):
        out.extend(pickle.loads(gathered[i, : int(all_n[i, 0])].tobytes()))
    return out
