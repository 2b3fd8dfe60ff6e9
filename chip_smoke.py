#!/usr/bin/env python3
"""Smoke test of the polish and SNV main paths on one GPU.

Drives the user entry points (``python -m ntedit_tpu engine|polish``
through ``ntedit_tpu.cli.main``) once at realistic sizes, with the device
work on the GPU and the native C++ repair engine, and checks every output
against an independent reference:

1. ``build``          50 Mbp genome -> 256 MiB filters built on the GPU in
                      the blocked and the btllib plain layout; each is
                      bit-identical to the filter built on the host.
2. ``polish-plain``   50 Mbp draft + the plain filter as a .bf file through
                      ``engine -t 4``; the edited sequence equals the
                      scalar C++ engine's (native/ntedit_baseline).
3. ``polish-blocked`` 250 Mbp draft + a 1 GiB blocked filter built on the
                      GPU through ``engine -t 4``; outputs equal the native
                      engine run on the CPU over every head, the device
                      gate set on a 25 Mbp slice equals the numpy host
                      gate set, and the dense pass is timed and traced.
4. ``snv``            SNV calling (``engine -s 1``) on a 50 Mbp genome with
                      SNVs injected at 1e-3 against the 1 GiB filter;
                      records and VCF body equal the native engine run on
                      the CPU over every head.
5. ``polish-reads``   4.7 Mbp draft + 30x 150 bp reads with 1% errors
                      through ``polish --reads -k 25``; the read filter
                      built on the GPU is bit-identical to its host
                      construction and the output equals the native
                      engine's on that filter.

All data is generated from fixed seeds.  Run from the repository root:

    python chip_smoke.py                # one GPU, the five phases above
    python chip_smoke.py --four-cards   # four GPUs of one host: sharded
                                        # mesh polish + a 4-rank CLI run,
                                        # each byte-equal to one card

Exits non-zero, before any phase and without a result line, unless JAX's
backend is ``gpu``.  The last line of standard output is one JSON object
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
K = 25

# H100 SXM device-memory bandwidth (NVIDIA data sheet), the bound of a
# random-gather pass: one 32-byte sector per Bloom probe.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
SECTOR_BYTES = 32


@dataclasses.dataclass(frozen=True)
class Sizes:
    genome: int = 50_000_000        # phases 1-2 truth / draft
    filter_bits: int = 1 << 31      # 256 MiB
    big: int = 250_000_000          # phase 3 draft
    big_bits: int = 1 << 33         # 1 GiB
    gate_slice: int = 25_000_000    # phase 3 host gate-set check
    snv: int = 50_000_000           # phase 4 genome
    reads_genome: int = 4_700_000   # phase 5 (E. coli scale)
    coverage: float = 30.0
    threads: int = 4


FULL = Sizes()


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _write_fasta(path: str, contigs) -> None:
    with open(path, "wb") as f:
        for name, seq in contigs:
            f.write(b">%s\n" % name.encode())
            f.write(seq.tobytes())
            f.write(b"\n")


def _read_outputs(prefix: str) -> dict:
    """The CLI's three output files; ##fileDate is dropped from the VCF
    (the clock may tick between two runs)."""
    out = {}
    for suffix in ("_edited.fa", "_changes.tsv", "_variants.vcf"):
        with open(prefix + suffix) as f:
            text = f.read()
        if suffix == "_variants.vcf":
            text = "".join(ln for ln in text.splitlines(True)
                           if not ln.startswith("##fileDate"))
        out[suffix] = text
    return out


def _render(results, draft_path: str, cfg) -> dict:
    """Render engine results exactly as the CLI writes them (presence
    filters)."""
    from ntedit_tpu.io import writers

    fa, tsv, vcf = io.StringIO(), io.StringIO(), io.StringIO()
    tsv.write(writers.changes_tsv_header(cfg.k, cfg.jump, False))
    vcf.write(writers.vcf_header(draft_path))
    for res in results:
        writers.write_contig(res, fa, tsv, vcf, {}, snv=cfg.snv)
    text = "".join(ln for ln in vcf.getvalue().splitlines(True)
                   if not ln.startswith("##fileDate"))
    return {"_edited.fa": fa.getvalue(), "_changes.tsv": tsv.getvalue(),
            "_variants.vcf": text}


def _cli(argv) -> float:
    """Run one CLI command in-process; returns its wall time."""
    from ntedit_tpu import cli

    t0 = time.time()
    cli.main(list(argv))
    return time.time() - t0


def _build_on_device(fasta: str, nbits: int, layouts=("blocked",)):
    """Device-built filters over every k-mer of ``fasta`` (one encode and
    upload per batch, fed to every layout's builder)."""
    from ntedit_tpu.core import bfbuild

    builders = [bfbuild.DeviceFilterBuilder(K, 3, nbits, 1 << 12, layout=lay)
                for lay in layouts]
    for buf in bfbuild._iter_separated_buffers([fasta], K):
        enc = builders[0].encode_batch(buf)
        for b in builders:
            b.insert_batch(enc, 1)
    return [b.finish() for b in builders]


def _unhinted(bf, cfg, header: str, seq):
    """The native engine on the CPU over every head (no device hint)."""
    from ntedit_tpu.engine import native_repair

    res = native_repair.polish_contig_native(bf, None, cfg, header, seq)
    if res is None:
        raise RuntimeError("native engine refused the filter layout")
    return res


def _same(got: dict, want: dict) -> dict:
    return {sfx: got[sfx] == want[sfx] for sfx in want}


def _holds(bf, truth) -> bool:
    """Guard against a vacuous comparison: the filter holds the truth's
    k-mers (a filter has no false negatives)."""
    return bool(bf.contains_seq_kmers(truth[:100_000]).all())


# ---------------------------------------------------------------------------
# phases (each returns {"ok": bool, ...printable details})
# ---------------------------------------------------------------------------

def phase_build(ctx: dict, sz: Sizes) -> dict:
    import numpy as np

    from ntedit_tpu.core import bfbuild, bloom
    from ntedit_tpu.utils import simulate

    if not bfbuild._device_backend_ok():
        raise RuntimeError("the device filter build path is off")
    work = ctx["work"]
    truth = simulate.random_genome(sz.genome, seed=11)
    fa = os.path.join(work, "truth.fa")
    _write_fasta(fa, [("truth", truth)])
    t0 = time.time()
    dev_blk, dev_pln = _build_on_device(fa, sz.filter_bits, ("blocked", "plain"))
    t_dev = time.time() - t0
    t0 = time.time()
    host_pln = bfbuild.build_genome_bf([fa], K, bf_bytes=sz.filter_bits // 8)
    host_blk = bloom.BlockedKmerBloomFilter.zeros(sz.filter_bits // 8, 3, K)
    for h in bfbuild._iter_hash_batches([fa], K):
        host_blk.insert_base(h)
    t_host = time.time() - t0
    ctx["truth"] = truth
    ctx["plain_bf"] = dev_pln
    blk_ok = bool(np.array_equal(dev_blk.words, host_blk.words))
    pln_ok = bool(np.array_equal(dev_pln.data, host_pln.data))
    holds = _holds(dev_blk, truth) and _holds(dev_pln, truth)
    return {
        "ok": blk_ok and pln_ok and holds,
        "blocked_identical": blk_ok, "plain_identical": pln_ok,
        "filters_hold_truth": holds,
        "filter_mib": sz.filter_bits >> 23, "bases": sz.genome,
        "device_build_s": round(t_dev, 3), "host_build_s": round(t_host, 3),
    }


def phase_polish_plain(ctx: dict, sz: Sizes) -> dict:
    from ntedit_tpu.utils import simulate

    work = ctx["work"]
    draft, _ = simulate.inject_errors(ctx["truth"], sub_rate=1e-3,
                                      ins_rate=1e-4, del_rate=1e-4, seed=12)
    fa = os.path.join(work, "plain_draft.fa")
    _write_fasta(fa, [("draft", draft)])
    bfp = os.path.join(work, "plain.bf")
    ctx["plain_bf"].save(bfp)
    prefix = os.path.join(work, "plain")
    t_cli = _cli(["engine", "-r", bfp, "-f", fa, "-t", str(sz.threads),
                  "-b", prefix, "--spill", "off"])
    with open(prefix + "_edited.fa") as f:
        got = "".join(ln.strip() for ln in f if not ln.startswith(">"))
    edited = os.path.join(work, "plain_baseline.txt")
    t0 = time.time()
    run = subprocess.run(
        [os.path.join(HERE, "native", "ntedit_baseline"), fa, bfp, edited],
        capture_output=True, text=True, check=True,
    )
    t_base = time.time() - t0
    with open(edited) as f:
        want = f.read().strip()
    stats = json.loads(run.stdout)
    edits = [stats["n_sub"], stats["n_ins"], stats["n_del"]]
    return {
        "ok": got == want and min(edits) > 0,
        "edited_identical_to_baseline": got == want,
        "bases": len(draft), "cli_s": round(t_cli, 3),
        "baseline_s": round(t_base, 3),
        "baseline_edits": edits,
    }


def _dense_pass(draft, df, chunk: int, work: str) -> dict:
    """Time the XLA dense pass (flag.iter_gate_chunks) warm, trace one
    pass, and reduce the trace to kernels and device time per chunk."""
    import jax
    import numpy as np

    from ntedit_tpu.engine import flag

    def one_pass():
        return sum(len(g) for _f, g in flag.iter_gate_chunks(draft, df,
                                                             chunk=chunk))

    t0 = time.time()
    one_pass()  # compile + pack-cache fill
    first_s = time.time() - t0
    times = []
    for _ in range(3):
        t0 = time.time()
        one_pass()
        times.append(time.time() - t0)
    n = len(draft) - K + 1
    eff = flag._effective_chunk(n, chunk)
    n_chunks = -(-n // eff)
    wall_ms = float(np.median(times)) * 1e3 / n_chunks
    trace_dir = os.path.join(work, "dense_trace")
    with jax.profiler.trace(trace_dir):
        one_pass()
    dev = _reduce_trace(trace_dir)
    out = {"chunk_heads": eff, "chunks": n_chunks,
           "first_pass_s": round(first_s, 3),
           "wall_ms_per_chunk": round(wall_ms, 3)}
    if dev is not None:
        out["kernels_per_chunk"] = round(dev["kernels"] / n_chunks, 2)
        out["distinct_kernels"] = dev["distinct"]
        out["device_ms_per_chunk"] = round(dev["busy_ms"] / n_chunks, 3)
        out["trace_lines"] = dev["lines"]
    kind = jax.devices()[0].device_kind
    peak = HBM_BYTES_PER_S.get(kind)
    if peak is None and jax.default_backend() == "gpu":
        raise KeyError(f"no memory bandwidth on record for {kind!r}")
    if peak is not None:
        floor_ms = eff * SECTOR_BYTES / peak * 1e3
        out["gather_floor_ms"] = round(floor_ms, 4)
        out["roofline_share_wall"] = round(floor_ms / wall_ms, 4)
        if dev is not None and dev["busy_ms"] > 0:
            out["roofline_share_device"] = round(
                floor_ms / (dev["busy_ms"] / n_chunks), 4)
    return out


def _reduce_trace(trace_dir: str):
    """Kernel launches and busy time on the GPU planes of one trace:
    events on the stream lines, memory copies and sets excluded; busy time
    is the union of the kernel intervals."""
    import glob

    import jax

    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        return None
    data = jax.profiler.ProfileData.from_file(sorted(paths)[-1])
    spans, names, lines = [], set(), set()
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.add(line.name)
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                low = ev.name.lower()
                if "memcpy" in low or "memset" in low:
                    continue
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                names.add(ev.name)
    spans.sort()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return {"kernels": len(spans), "distinct": len(names),
            "busy_ms": busy / 1e6, "lines": sorted(lines)}


def phase_polish_blocked(ctx: dict, sz: Sizes) -> dict:
    import numpy as np

    from ntedit_tpu.core import bloom
    from ntedit_tpu.core import nthash_ref as nh
    from ntedit_tpu.engine import flag
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.utils import simulate

    work = ctx["work"]
    truth = simulate.random_genome(sz.big, seed=21)
    draft, _ = simulate.inject_errors(truth, sub_rate=1e-3, ins_rate=1e-4,
                                      del_rate=1e-4, seed=22)
    tfa = os.path.join(work, "big_truth.fa")
    _write_fasta(tfa, [("truth", truth)])
    t0 = time.time()
    (bf,) = _build_on_device(tfa, sz.big_bits)
    t_build = time.time() - t0
    bfp = os.path.join(work, "big_blocked.bf")
    bf.save(bfp)
    fa = os.path.join(work, "big_draft.fa")
    _write_fasta(fa, [("draft", draft)])
    prefix = os.path.join(work, "big")
    t_cli = _cli(["engine", "-r", bfp, "-f", fa, "-t", str(sz.threads),
                  "-b", prefix, "--spill", "off"])
    cfg = EngineConfig(k=K, hash_num=3, threads=sz.threads).validate()
    t0 = time.time()
    ref = _unhinted(bf, cfg, "draft", draft)
    t_ref = time.time() - t0
    same = _same(_read_outputs(prefix), _render([ref], fa, cfg))

    # device gate set == numpy host gate set on a slice
    df = bloom.DeviceFilter.from_host(bf)
    sl = draft[: sz.gate_slice]
    dev_gates = flag.flag_contig_gates(sl, df)
    fh, rh = nh.all_window_hashes(sl, K)
    host_gates = np.flatnonzero(~bf.contains_base(nh.canonical(fh, rh)))
    gates_ok = bool(np.array_equal(dev_gates, host_gates))
    holds = _holds(bf, truth)

    dense = _dense_pass(draft, df, flag.DEFAULT_CHUNK, work)
    ctx["big_truth"] = truth
    ctx["big_bf"] = bf
    ctx["big_bf_path"] = bfp
    return {
        "ok": all(same.values()) and gates_ok and holds and len(ref.subs) > 0,
        "outputs_identical": same, "slice_gates_identical": gates_ok,
        "filter_holds_truth": holds,
        "slice_gates": len(host_gates), "bases": len(draft),
        "records": len(ref.subs), "device_build_s": round(t_build, 3),
        "cli_s": round(t_cli, 3), "cpu_engine_s": round(t_ref, 3),
        "dense_pass": dense,
    }


def phase_snv(ctx: dict, sz: Sizes) -> dict:
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.utils import simulate

    work = ctx["work"]
    genome, _ = simulate.inject_errors(ctx["big_truth"][: sz.snv],
                                       sub_rate=1e-3, ins_rate=0.0,
                                       del_rate=0.0, seed=31)
    fa = os.path.join(work, "snv.fa")
    _write_fasta(fa, [("snv", genome)])
    prefix = os.path.join(work, "snv")
    t_cli = _cli(["engine", "-s", "1", "-r", ctx["big_bf_path"], "-f", fa,
                  "-t", str(sz.threads), "-b", prefix, "--spill", "off"])
    cfg = EngineConfig(k=K, hash_num=3, snv=True,
                       threads=sz.threads).validate()
    t0 = time.time()
    ref = _unhinted(ctx["big_bf"], cfg, "snv", genome)
    t_ref = time.time() - t0
    got = _read_outputs(prefix)
    want = _render([ref], fa, cfg)
    same = {s: got[s] == want[s] for s in ("_changes.tsv", "_variants.vcf")}
    return {"ok": all(same.values()) and len(ref.subs) > 0,
            "outputs_identical": same,
            "bases": len(genome), "records": len(ref.subs),
            "cli_s": round(t_cli, 3), "cpu_engine_s": round(t_ref, 3)}


def _host_read_filter(paths, hist, cutoff: int):
    """Host construction of the on-device read filter: count-min
    multiplicities in 8-bit counters, then the k-mers at or above the
    cutoff into a blocked filter, at the sizes the device build uses."""
    import numpy as np

    from ntedit_tpu.core import bfbuild, bloom
    from ntedit_tpu.core import nthash_ref as nh

    nbits, slots = bfbuild.device_filter_sizes(hist, cutoff)
    counter = bloom.KmerCountingBloomFilter8.zeros(slots, 3, K)
    for h in bfbuild._iter_hash_batches(paths, K):
        counter.insert_hashes(nh.extend_hashes_vec(h, K, 3))
    bf = bloom.BlockedKmerBloomFilter.zeros(nbits // 8, 3, K)
    for h in bfbuild._iter_hash_batches(paths, K):
        keep = counter.count_hashes(nh.extend_hashes_vec(h, K, 3)) >= cutoff
        if np.any(keep):
            bf.insert_base(h[keep])
    return bf


def phase_polish_reads(ctx: dict, sz: Sizes) -> dict:
    import numpy as np

    from ntedit_tpu.core import bfbuild, bloom
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.utils import simulate

    work = os.path.join(ctx["work"], "reads")
    os.makedirs(work, exist_ok=True)
    genome = simulate.random_genome(sz.reads_genome, seed=41)
    draft, _ = simulate.inject_errors(genome, sub_rate=1e-3, ins_rate=1e-4,
                                      del_rate=1e-4, seed=42)
    _write_fasta(os.path.join(work, "draft.fa"), [("draft", draft)])
    fq = os.path.join(work, "myReads_1.fq")
    n_reads = simulate.write_reads_fastq(fq, genome, coverage=sz.coverage,
                                         read_len=150, err_rate=0.01, seed=43)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t_cli = _cli(["polish", "--draft", "draft.fa", "--reads", "myReads",
                      "-k", str(K), "-t", str(sz.threads), "--spill", "off"])
    finally:
        os.chdir(cwd)
    dev_bf = bloom.load_any(os.path.join(work, "myReads_k25.bf"))
    hist = bfbuild.Histogram.load(os.path.join(work, "myReads_k25.hist"), k=K)
    t0 = time.time()
    host_bf = _host_read_filter([fq], hist, cutoff=2)
    t_host = time.time() - t0
    filter_ok = bool(
        isinstance(dev_bf, bloom.BlockedKmerBloomFilter)
        and np.array_equal(dev_bf.words, host_bf.words))
    cfg = EngineConfig(k=K, hash_num=3, threads=sz.threads).validate()
    ref = _unhinted(dev_bf, cfg, "draft", draft)
    same = _same(_read_outputs(os.path.join(work, "ntedit_k25")),
                 _render([ref], "draft.fa", cfg))
    return {
        "ok": filter_ok and all(same.values()) and len(ref.subs) > 0,
        "read_filter_identical": filter_ok, "outputs_identical": same,
        "reads": n_reads, "filter_mib": dev_bf.bytes >> 20,
        "records": len(ref.subs), "cli_s": round(t_cli, 3),
        "host_filter_s": round(t_host, 3),
    }


PHASES = (
    ("build", phase_build),
    ("polish-plain", phase_polish_plain),
    ("polish-blocked", phase_polish_blocked),
    ("snv", phase_snv),
    ("polish-reads", phase_polish_reads),
)


# ---------------------------------------------------------------------------
# four cards: sharded mesh polish and a multi-rank CLI run
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multirank(ctx: dict, sz: Sizes, n_ranks: int = 4) -> dict:
    """Four CLI ranks on one host, one card each (the launcher sets
    CUDA_VISIBLE_DEVICES per rank); rank 0's merged output must equal a
    single-process run on one card.  Runs before this process allocates
    on any card, so every rank can reserve its card's memory."""
    from ntedit_tpu.core import bloom
    from ntedit_tpu.utils import simulate

    work = os.path.join(ctx["work"], "multirank")
    os.makedirs(work, exist_ok=True)
    n_contigs = 16
    clen = sz.genome // n_contigs
    bf = bloom.BlockedKmerBloomFilter.zeros(sz.filter_bits // 8, 3, K)
    contigs = []
    for i in range(n_contigs):
        truth = simulate.random_genome(clen, seed=500 + i)
        bf.insert_seq(truth)
        draft, _ = simulate.inject_errors(truth, sub_rate=1e-3, ins_rate=1e-4,
                                          del_rate=1e-4, seed=600 + i)
        contigs.append((f"ctg{i}", draft))
    fa = os.path.join(work, "draft.fa")
    _write_fasta(fa, contigs)
    bfp = os.path.join(work, "truth.bf")
    bf.save(bfp)
    cmd = [sys.executable, "-m", "ntedit_tpu", "engine", "-r", bfp, "-f", fa,
           "-t", str(sz.threads), "--spill", "off"]
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")

    t0 = time.time()
    single = subprocess.run(cmd + ["-b", os.path.join(work, "single")],
                            env=dict(env, CUDA_VISIBLE_DEVICES="0"),
                            capture_output=True, text=True)
    t_single = time.time() - t0
    if single.returncode != 0:
        raise RuntimeError(f"single-process run failed:\n{single.stdout}\n"
                           f"{single.stderr}")
    port = _free_port()
    t0 = time.time()
    procs = [
        subprocess.Popen(
            cmd + ["-b", os.path.join(work, "multi")],
            env=dict(env, CUDA_VISIBLE_DEVICES=str(r),
                     NTEDIT_TPU_COORDINATOR=f"127.0.0.1:{port}",
                     NTEDIT_TPU_NUM_PROCESSES=str(n_ranks),
                     NTEDIT_TPU_PROCESS_ID=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n_ranks)
    ]
    outs = [p.communicate()[0] for p in procs]
    t_multi = time.time() - t0
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} failed:\n{o}")
    ranks = [ln for o in outs for ln in o.splitlines()
             if ln.startswith("[rank")]
    from ntedit_tpu.io import writers

    want = _read_outputs(os.path.join(work, "single"))
    same = _same(_read_outputs(os.path.join(work, "multi")), want)
    records = (len(want["_changes.tsv"].splitlines())
               - len(writers.changes_tsv_header(K, 3, False).splitlines()))
    return {"ok": all(same.values()) and records > 0,
            "outputs_identical": same, "records": records,
            "contigs": n_contigs, "bases": n_contigs * clen,
            "single_s": round(t_single, 3), "ranks_s": round(t_multi, 3),
            "rank_lines": ranks}


def phase_sharded(ctx: dict, sz: Sizes, n_dev: int = 4) -> dict:
    """mesh.sharded_polish over an n_dev-card mesh: the 1 GiB filter is
    built from the truth by the ring-OR build and replicated, the 250 Mbp
    draft is sharded; the result equals the single-card Polisher's."""
    import numpy as np

    from ntedit_tpu.core import bloom
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.polish import Polisher
    from ntedit_tpu.parallel import mesh as pmesh
    from ntedit_tpu.utils import simulate

    work = ctx["work"]
    rows = 16 * n_dev
    row_heads = -(-(sz.big - K + 1) // rows)
    length = rows * row_heads + K - 1  # rows tile the truth exactly
    truth = simulate.random_genome(length, seed=21)
    draft, _ = simulate.inject_errors(truth, sub_rate=1e-3, ins_rate=1e-4,
                                      del_rate=1e-4, seed=22)
    shards = np.lib.stride_tricks.sliding_window_view(
        truth, row_heads + K - 1)[::row_heads][:rows]
    mesh = pmesh.make_mesh(n_dev)
    t0 = time.time()
    words = pmesh.sharded_bf_build(mesh, np.ascontiguousarray(shards), K, 3,
                                   sz.big_bits)
    words.block_until_ready()
    t_ring = time.time() - t0
    host_words = np.asarray(words)
    bf = bloom.KmerBloomFilter(host_words.view(np.uint8).copy(), 3, K)
    tfa = os.path.join(work, "shard_truth.fa")
    _write_fasta(tfa, [("truth", truth)])
    (one_card,) = _build_on_device(tfa, sz.big_bits, ("plain",))
    build_ok = bool(np.array_equal(one_card.data, bf.data)) and _holds(bf, truth)
    cfg = EngineConfig(k=K, hash_num=3, threads=sz.threads).validate()
    t0 = time.time()
    res_mesh = pmesh.sharded_polish(mesh, "draft", draft, bf, words, cfg,
                                    threads=sz.threads)
    t_mesh = time.time() - t0
    pol = Polisher(bf, None, cfg)  # on the default device, card 0
    t0 = time.time()
    res_one = pol.polish_contig("draft", draft)
    t_one = time.time() - t0
    fa = os.path.join(work, "shard_draft.fa")
    same = _same(_render([res_mesh], fa, cfg), _render([res_one], fa, cfg))
    return {"ok": build_ok and all(same.values()) and len(res_one.subs) > 0,
            "ring_or_filter_identical": build_ok, "outputs_identical": same,
            "devices": n_dev, "bases": len(draft),
            "records": len(res_one.subs), "ring_or_build_s": round(t_ring, 3),
            "sharded_polish_s": round(t_mesh, 3),
            "one_card_polish_s": round(t_one, 3)}


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _run_phase(name: str, fn, ctx: dict, sz: Sizes, compile_s: list) -> bool:
    """Run one phase; ``compile_s[0]`` accumulates JAX's tracing, lowering
    and compile seconds (cold or from the cache)."""
    t0 = time.time()
    c0 = compile_s[0]
    try:
        res = fn(ctx, sz)
    except Exception:
        traceback.print_exc()
        res = {"ok": False, "error": traceback.format_exc(limit=1).strip()}
    res["wall_s"] = round(time.time() - t0, 3)
    res["compile_s"] = round(compile_s[0] - c0, 3)
    ok = res.pop("ok") is True
    log(f"phase {name}: {'PASS' if ok else 'FAIL'} {json.dumps(res)}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths (sharded mesh polish "
                         "and a 4-rank CLI run) and their comparisons")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "ntedit_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.four_cards:
        # the ranks of the multi-rank phase reserve their cards' memory;
        # this process allocates on demand until they have finished
        os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX's backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    devices = jax.devices()
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"need {want} GPUs, JAX sees {len(devices)}", file=sys.stderr)
        return 1

    import ntedit_tpu
    from bench import gpu_info
    from ntedit_tpu.engine import native_repair
    from ntedit_tpu.io import native as native_io

    cards = gpu_info()
    if cards is None:
        print("nvidia-smi gave no card name and power limit", file=sys.stderr)
        return 1
    for line in cards.splitlines():
        log(f"gpu: {line}")
    platform = " ".join(devices[0].client.platform_version.split())
    log(f"jax {jax.__version__}; {platform}; "
        f"{len(devices)} x {devices[0].device_kind}")
    log("compile cache: " + str(jax.config.jax_compilation_cache_dir)
        + (" (JAX_COMPILATION_CACHE_DIR)"
           if os.environ.get("JAX_COMPILATION_CACHE_DIR") else
           f" (default {ntedit_tpu.DEFAULT_CACHE_DIR})"))
    t0 = time.time()
    make = subprocess.run(
        ["make", "-C", os.path.join(HERE, "native"), "libntpu_io.so",
         "libntedit_repair.so", "ntedit_baseline"],
        capture_output=True, text=True)
    log(f"native build: rc={make.returncode} {time.time() - t0:.1f}s")
    if make.returncode != 0:
        print(make.stdout + make.stderr, file=sys.stderr)
        return 1
    if not native_repair.available():
        print(f"repair engine unavailable: {native_repair.build_error()}",
              file=sys.stderr)
        return 1
    log("repair engine: native C++ (native/libntedit_repair.so)")
    log("fastx reader: " + ("native (native/libntpu_io.so)"
                            if native_io.get_lib() is not None else "python"))

    compile_s = [0.0]

    def count_compile(event: str, secs: float, **_kw) -> None:
        if event.startswith("/jax/core/compile/"):
            compile_s[0] += secs

    jax.monitoring.register_event_duration_secs_listener(count_compile)
    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ctx = {"work": work}
    phases = PHASES
    if args.four_cards:
        phases = (("multirank", phase_multirank), ("sharded", phase_sharded))
    ok = True
    t0 = time.time()
    for name, fn in phases:
        ok &= _run_phase(name, fn, ctx, FULL, compile_s)
    log(f"all phases: {time.time() - t0:.1f}s, of which compiling "
        f"{compile_s[0]:.1f}s")
    if not ok:
        log("chip smoke FAILED")
        return 1
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
