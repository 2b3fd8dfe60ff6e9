"""Multi-host runtime: 2 REAL processes, byte-identical merged output.

Spawns two localhost CPU processes that join a JAX multi-controller
cluster (jax.distributed) and run the engine CLI on a multi-contig
corpus; rank 0's merged _edited.fa/_changes.tsv/_variants.vcf must
byte-equal a single-process run.  This executes the full multi-host data
flow — initialize_from_env -> process_slice ownership -> per-rank polish
-> gather_records -> rank-0 writers (parallel/distributed.py docstring;
role: SURVEY.md §5.8).
"""

import os
import socket
import subprocess
import sys

import numpy as np

from ntedit_tpu.core import bloom
from ntedit_tpu.utils import simulate

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.abspath(os.path.join(HERE, os.pardir))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _make_corpus(tmp_path, n_contigs=7, length=9000, k=25):
    rng = np.random.default_rng(2)
    contigs = []
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 18, 3, k)
    fa = tmp_path / "draft.fa"
    with open(fa, "w") as f:
        for i in range(n_contigs):
            truth = simulate.random_genome(length + 257 * i, seed=100 + i)
            draft, _ = simulate.inject_errors(
                truth, sub_rate=2e-3, ins_rate=2e-4, del_rate=2e-4,
                seed=200 + i,
            )
            bf.insert_seq(truth)
            if i == 3:
                draft = draft.copy()
                draft[rng.integers(0, len(draft), size=5)] = ord("N")
            f.write(f">ctg{i} sim\n{draft.tobytes().decode()}\n")
            contigs.append(draft)
    bfp = tmp_path / "truth.bf"
    bf.save(str(bfp))
    return str(fa), str(bfp)


def _run_cli(workdir, draft, bfp, prefix, extra_env=None, timeout=300):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # one CPU device per process
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if extra_env:
        env.update(extra_env)
    return subprocess.Popen(
        [sys.executable, "-m", "ntedit_tpu", "engine",
         "-r", bfp, "-f", draft, "-b", prefix, "-t", "1", "-z", "100"],
        cwd=workdir, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _read_outputs(workdir, prefix):
    out = {}
    for suffix in ("_edited.fa", "_changes.tsv", "_variants.vcf"):
        with open(os.path.join(workdir, prefix + suffix), "rb") as f:
            data = f.read()
        if suffix == "_variants.vcf":
            # ##fileDate can straddle the clock between runs
            data = b"\n".join(
                ln for ln in data.split(b"\n")
                if not ln.startswith(b"##fileDate")
            )
        out[suffix] = data
    return out


def test_two_process_run_matches_single(tmp_path):
    draft, bfp = _make_corpus(tmp_path)

    # single-process reference run
    single = _run_cli(str(tmp_path), draft, bfp, "single")
    out, _ = single.communicate(timeout=300)
    assert single.returncode == 0, out
    want = _read_outputs(str(tmp_path), "single")

    # two real processes joined via jax.distributed
    port = _free_port()
    procs = []
    for rank in range(2):
        procs.append(_run_cli(
            str(tmp_path), draft, bfp, "multi",
            extra_env={
                "NTEDIT_TPU_COORDINATOR": f"127.0.0.1:{port}",
                "NTEDIT_TPU_NUM_PROCESSES": "2",
                "NTEDIT_TPU_PROCESS_ID": str(rank),
            },
        ))
    outs = []
    for p in procs:
        o, _ = p.communicate(timeout=420)
        outs.append(o)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{o}"
    assert "[rank 0/2]" in outs[0] and "[rank 1/2]" in outs[1]

    got = _read_outputs(str(tmp_path), "multi")
    for suffix in want:
        assert got[suffix] == want[suffix], f"{suffix} differs across runs"
