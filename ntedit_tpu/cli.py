"""Command-line interface: the reference's L5+L4+L3 surfaces in one tool.

Three reference entry points map onto subcommands of ``python -m ntedit_tpu``:

* ``polish`` / ``snv``  — run-ntedit's subcommands (run-ntedit:24-129) plus
  the Snakemake pipeline's role (ntedit_run_pipeline.smk): reads-prefix
  expansion, ntcard-role histogram, ntstat-role Bloom filter, then the
  engine — with file-artifact stage caching replacing Snakemake's
  skip-if-output-exists/--rerun-trigger mtime behavior
  (run-ntedit:232-239: ``-n`` dry run, ``-f``/``--force`` rerun).
* ``engine``            — the ntedit executable's direct CLI for advanced
  users (ntedit.cpp:52-97; README.md:231), every flag/default/clamp
  preserved, k and hash count read from the Bloom-filter header
  (ntedit.cpp:2439-2448).
* ``make-genome-bf``    — ntedit_make_genome_bf
  (src/ntedit_make_genome_bf.cpp:53-98).

Output naming matches the pipeline: ``{b}ntedit_k{k}_edited.fa`` etc.
(ntedit_run_pipeline.smk:141-152); the engine's default prefix is the
reference's auto-composed ``<draft>_k<k>_z<z>_r<bf>_i<i>_d<d>_m<m>``
(ntedit.cpp:2494-2501).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

VERSION = "ntedit_tpu 0.1.0 (capabilities of ntEdit v2.1.1)"


# ---------------------------------------------------------------------------
# stage cache (Snakemake role)
# ---------------------------------------------------------------------------

def _stale(output: str, inputs: list[str]) -> bool:
    """True if output is missing or older than any input (Snakemake's
    --rerun-trigger mtime contract, run-ntedit:232-233)."""
    if not os.path.exists(output):
        return True
    out_m = os.path.getmtime(output)
    return any(os.path.exists(i) and os.path.getmtime(i) > out_m for i in inputs)


class Stages:
    def __init__(self, force: bool, dry_run: bool):
        self.force = force
        self.dry_run = dry_run

    def run(self, outputs: list[str], inputs: list[str], desc: str, fn) -> bool:
        need = self.force or any(_stale(o, inputs) for o in outputs)
        if not need:
            print(f"[cached] {desc}", flush=True)
            return False
        if self.dry_run:
            print(f"[would run] {desc}", flush=True)
            return False
        t0 = time.time()
        print(f"[running] {desc}", flush=True)
        fn()
        print(f"[done {time.time() - t0:.1f}s] {desc}", flush=True)
        return True


def _expand_reads_prefix(prefix: str) -> list[str]:
    """All files in the working directory with the given prefix
    (run-ntedit --reads contract; ntedit_run_pipeline.smk help text)."""
    exts = (".fq", ".fastq", ".fa", ".fasta", ".fq.gz", ".fastq.gz",
            ".fa.gz", ".fasta.gz")
    hits = sorted(
        p for p in glob.glob(prefix + "*")
        if p.endswith(exts) and os.path.isfile(p)
    )
    if not hits:
        raise SystemExit(f"no read files match prefix '{prefix}'")
    return hits


def _estimated_draft_bytes(path: str) -> int:
    """Uncompressed draft size estimate for the spill='auto' threshold.
    A multi-Gbp .fa.gz compresses well under the raw threshold, which is
    exactly the expensive-restart case spill targets: for .gz read the
    gzip trailer ISIZE (uncompressed size mod 2^32); when it wrapped
    (reads smaller than the compressed stream) fall back to 4x the
    compressed size (typical FASTA gzip ratio)."""
    size = os.path.getsize(path)
    if not path.endswith(".gz"):
        return size
    try:
        with open(path, "rb") as f:
            f.seek(-4, os.SEEK_END)
            isize = int.from_bytes(f.read(4), "little")
    except OSError:
        isize = 0
    return isize if isize >= size else size * 4


# ---------------------------------------------------------------------------
# engine invocation (shared by all paths)
# ---------------------------------------------------------------------------

def _run_engine(
    bf_path: str,
    draft_path: str,
    prefix: str | None,
    *,
    reject_path: str | None = None,
    vcf_path: str | None = None,
    threads: int = 4,
    z: int = 100,
    i: int = 5,
    d: int = 5,
    x: float = 5.0,
    y: float = 9.0,
    X: float = -1.0,
    Y: float = -1.0,
    j: int = 3,
    m: int = 0,
    s: int = 0,
    a: int = 0,
    v: int = 0,
    p: int = 1,
    q: int = 255,
    spill: str = "auto",
) -> str:
    from ntedit_tpu.core import bloom
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.polish import Polisher
    from ntedit_tpu.io import fastx, writers

    host_bf = bloom.load_any(bf_path)
    counting = hasattr(host_bf, "counters")
    k = host_bf.k
    if not counting:
        p = 1  # -p forced to 1 for non-counting BF (ntedit.cpp:2453-2458)

    bloomrep = bloom.load_any(reject_path) if reject_path else None
    if bloomrep is not None and bloomrep.k != k:
        raise SystemExit(
            f"secondary BF k ({bloomrep.k}) != primary k ({k})"
        )  # ntedit.cpp:2581-2585

    use_ratio = X != -1 or Y != -1
    if use_ratio:
        X = 0.5 if X == -1 else X
        Y = 0.5 if Y == -1 else Y

    cfg = EngineConfig(
        k=k, hash_num=host_bf.hash_num, min_contig_len=z,
        max_insertions=i, max_deletions=d, missing_threshold=x,
        edit_threshold=y, use_ratio=use_ratio, missing_ratio=max(X, 0.0),
        edit_ratio=max(Y, 0.0), jump=j, mode=m, snv=bool(s), mask=bool(a),
        min_threshold=p, max_threshold=q, verbose=bool(v),
        threads=max(1, threads),
    ).validate()

    if not prefix:
        db = os.path.basename(draft_path)
        bb = os.path.basename(bf_path)
        prefix = (
            f"{db}_k{k}_z{z}_r{bb}_i{cfg.max_insertions}"
            f"_d{cfg.max_deletions}_m{m}"
        )

    clinvar = writers.read_annotation_vcf(vcf_path) if vcf_path else {}

    from ntedit_tpu.parallel import distributed as dist

    if dist.active():
        _run_engine_multihost(
            host_bf, bloomrep, cfg, draft_path, prefix, clinvar,
        )
        return prefix

    print(
        f"running: {writers.PROGRAM}\n -f {os.path.basename(draft_path)}"
        f"\n -k {k}\n -z {z}\n -b {prefix}\n -r {os.path.basename(bf_path)}"
        f"\n -i {cfg.max_insertions}\n -d {cfg.max_deletions}"
        + (f"\n -X {X}\n -Y {Y}" if use_ratio else f"\n -x {x}\n -y {y}")
        + f"\n -j {j}\n -m {m}\n -s {s}\n -a {a}\n -t {threads}\n -v {v}",
        flush=True,
    )
    if counting:
        print(f" -p {p}\n -q {q}", flush=True)

    pol = Polisher(host_bf, bloomrep, cfg)

    # per-contig record spill: crash-safe resume at contig granularity
    # (io/spill.py; SURVEY §5.4's intra-stage checkpoint mirror).  auto =
    # on for big drafts where an interrupted run is expensive to restart
    sp = None
    if spill == "on" or (
        spill == "auto" and _estimated_draft_bytes(draft_path) > (256 << 20)
    ):
        import dataclasses as _dc

        from ntedit_tpu.io.spill import ContigSpill

        def _fid(path):
            try:
                st = os.stat(path)
                return [path, st.st_size, st.st_mtime]
            except OSError:
                return [path, 0, 0]

        sp = ContigSpill(prefix, {
            "cfg": {f.name: getattr(cfg, f.name) for f in _dc.fields(cfg)},
            "draft": _fid(draft_path), "bf": _fid(bf_path),
            "reject": _fid(reject_path) if reject_path else None,
            "vcf": _fid(vcf_path) if vcf_path else None,
        })

    import io as _io
    from collections import deque

    events = deque()  # input-order: ("cached", frags) | ("fresh", idx, hdr, L, crc)

    with open(prefix + "_edited.fa", "w") as dfout, \
         open(prefix + "_changes.tsv", "w") as rfout, \
         open(prefix + "_variants.vcf", "w") as vfout:
        rfout.write(writers.changes_tsv_header(k, j, counting))
        vfout.write(writers.vcf_header(draft_path))
        t0 = time.time()
        total_bases = 0
        n_contigs = 0
        n_records = 0
        from ntedit_tpu.utils.profiling import trace

        def contig_stream():
            for idx, rec in enumerate(fastx.read_fastx(draft_path)):
                # contigs shorter than -z are read but not polished/emitted
                # (ntedit.cpp:2242) — polish() applies the same filter
                if len(rec.seq) < cfg.min_contig_len:
                    continue
                if sp is not None:
                    crc = sp.crc(rec.seq)
                    got = sp.get(idx, rec.header, len(rec.seq), crc)
                    if got is not None:
                        events.append(("cached", got, len(rec.seq)))
                        continue
                    events.append(("fresh", idx, rec.header, len(rec.seq), crc))
                else:
                    events.append(("fresh", None, None, len(rec.seq), None))
                if v:
                    print(rec.header, flush=True)
                yield rec.header, rec.seq

        def _write_cached(frags):
            nonlocal total_bases, n_contigs, n_records
            fa_s, tsv_s, vcf_s = frags
            dfout.write(fa_s)
            rfout.write(tsv_s)
            vfout.write(vcf_s)
            n_contigs += 1
            n_records += tsv_s.count("\n")

        with trace():  # device trace when NTEDIT_TPU_TRACE is set
            # pol.polish overlaps contigs two-deep with -t > 1 and keeps
            # input-order output (FIDELITY #6).  Results pair 1:1, in
            # order, with the "fresh" events (cached contigs never enter
            # the stream), so the merge below IS input order even though
            # the pipeline reads a few contigs ahead.
            res_iter = iter(pol.polish(contig_stream()))
            while True:
                if not events:
                    try:
                        held = next(res_iter)
                    except StopIteration:
                        break
                else:
                    held = None
                while events and events[0][0] == "cached":
                    ev = events.popleft()
                    _write_cached(ev[1])
                    total_bases += ev[2]
                if not events:
                    if held is not None:  # cannot happen: a result's fresh
                        # event is always enqueued before the result exists
                        raise RuntimeError("spill merge lost a result")
                    continue  # only cached events were pending
                ev = events.popleft()  # the fresh event for the next result
                res = held if held is not None else next(res_iter)
                if sp is not None:
                    fa_b, tsv_b, vcf_b = _io.StringIO(), _io.StringIO(), _io.StringIO()
                    writers.write_contig(res, fa_b, tsv_b, vcf_b, clinvar,
                                         snv=cfg.snv)
                    frags = (fa_b.getvalue(), tsv_b.getvalue(), vcf_b.getvalue())
                    sp.put(ev[1], ev[2], ev[3], ev[4], *frags)
                    for f, s in zip((dfout, rfout, vfout), frags):
                        f.write(s)
                else:
                    writers.write_contig(
                        res, dfout, rfout, vfout, clinvar, snv=cfg.snv
                    )
                total_bases += len(res.contig)
                n_contigs += 1
                n_records += len(res.subs)
    if sp is not None:
        sp.finalize()
    dt = max(time.time() - t0, 1e-9)
    # per-stage throughput counter (observability parity: the reference
    # wraps stages in GNU time, ntedit_run_pipeline.smk:78-81)
    print(
        f"engine: {n_contigs} contigs, {total_bases:,} bp in {dt:.2f}s "
        f"({total_bases / dt:,.0f} bp/s), {n_records} records",
        flush=True,
    )
    return prefix


def _run_engine_multihost(
    host_bf, bloomrep, cfg, draft_path: str, prefix: str, clinvar: dict
) -> None:
    """Multi-host polish: every process owns a contiguous slice of the
    input contigs (parallel.distributed.process_slice), polishes them
    against its own copy of the filter, renders each contig's three
    output fragments locally, and rank 0 writes the merged files in input
    order after a host allgather (gather_records) — deterministic output,
    byte-identical to a single-process run (tests/test_multihost.py).

    The reference's only parallelism is per-contig OpenMP threads in one
    address space (/root/reference/ntedit.cpp:2213); this is the scale-out
    equivalent the accelerator runtime gets from the JAX multi-controller
    model (SURVEY.md §5.8)."""
    import io as _io

    import jax

    from ntedit_tpu.engine.polish import Polisher
    from ntedit_tpu.io import fastx, writers
    from ntedit_tpu.parallel import distributed as dist

    n = fastx.count_records(draft_path)
    sl = dist.process_slice(n)
    rank = jax.process_index()
    print(f"[rank {rank}/{jax.process_count()}] contigs "
          f"[{sl.start}, {min(sl.stop, n)}) of {n}", flush=True)

    pol = Polisher(host_bf, bloomrep, cfg)
    t0 = time.time()
    total_bases = 0
    n_records = 0

    def owned_stream():
        for i, rec in enumerate(fastx.read_fastx(draft_path)):
            if sl.start <= i < sl.stop:
                yield rec.header, rec.seq

    rendered = []
    for res in pol.polish(owned_stream()):
        fa, tsv, vcf = _io.StringIO(), _io.StringIO(), _io.StringIO()
        writers.write_contig(res, fa, tsv, vcf, clinvar, snv=cfg.snv)
        rendered.append((fa.getvalue(), tsv.getvalue(), vcf.getvalue()))
        total_bases += len(res.contig)
        n_records += len(res.subs)
    dt = max(time.time() - t0, 1e-9)
    print(f"[rank {rank}] {len(rendered)} contigs, {total_bases:,} bp in "
          f"{dt:.2f}s ({total_bases / dt:,.0f} bp/s), {n_records} records",
          flush=True)

    # process_slice is contiguous in input order and gather_records
    # concatenates in process order, so the merge IS input order
    parts = dist.gather_records(rendered)
    if rank == 0:
        counting = hasattr(host_bf, "counters")
        with open(prefix + "_edited.fa", "w") as dfout, \
             open(prefix + "_changes.tsv", "w") as rfout, \
             open(prefix + "_variants.vcf", "w") as vfout:
            rfout.write(writers.changes_tsv_header(cfg.k, cfg.jump, counting))
            vfout.write(writers.vcf_header(draft_path))
            for fa, tsv, vcf in parts:
                dfout.write(fa)
                rfout.write(tsv)
                vfout.write(vcf)


# ---------------------------------------------------------------------------
# pipeline stages
# ---------------------------------------------------------------------------

def _reads_filter_stages(stages, reads_prefix, k, cutoff, solid, fpr, cbf=False):
    """ntcard + ntstat role: histogram + read BF/CBF with stage caching.
    Artifact names match the Snakemake rules (ntedit_run_pipeline.smk:
    155-176, 192-202)."""
    from ntedit_tpu.core import bfbuild

    read_files = _expand_reads_prefix(reads_prefix)
    hist_path = f"{reads_prefix}_k{k}.hist"
    bf_path = f"{reads_prefix}_k{k}" + (".cbf" if cbf else ".bf")

    def make_hist():
        bfbuild.count_histogram(read_files, k).save(hist_path)

    stages.run([hist_path], read_files, f"ntcard-role histogram -> {hist_path}",
               make_hist)

    def make_bf():
        hist = bfbuild.Histogram.load(hist_path, k=k)
        filt, _, used_cutoff = bfbuild.build_read_filter(
            read_files, k, cutoff=cutoff, solid=solid, fpr=fpr,
            counts=cbf, hist=hist,
        )
        filt.save(bf_path)
        print(f"  cutoff={used_cutoff} bytes={filt.bytes}", flush=True)

    stages.run([bf_path], read_files + [hist_path],
               f"ntstat-role filter -> {bf_path}", make_bf)
    return bf_path


def cmd_polish(args) -> None:
    if args.cap is not None:
        # the reference unconditionally overrides -c with k*1.5 after the
        # BF loads (ntedit.cpp:2450-2451) — the flag is dead in v2.1.1;
        # accepted for CLI parity, warned, and ignored (FIDELITY.md #7)
        print(
            "warning: --cap has no effect (the v2.1.1 engine overrides the "
            "insertion cap to k*1.5; see FIDELITY.md #7)",
            file=sys.stderr, flush=True,
        )
    stages = Stages(args.force, args.dry_run)
    bf_path = _reads_filter_stages(
        stages, args.reads, args.k, args.cutoff, args.solid, args.e,
        cbf=args.cbf,
    )
    b = args.b + "_" if getattr(args, "b", "") else ""
    prefix = f"{b}ntedit_k{args.k}"
    draft = args.draft

    def engine():
        _run_engine(
            bf_path, draft, prefix, vcf_path=args.l, threads=args.t,
            z=args.z, i=args.i, d=args.d, x=args.x, y=args.y, X=args.X,
            Y=args.Y, j=args.j, m=args.m, a=args.a, v=int(args.v),
            p=args.p, q=args.q, spill=args.spill,
        )

    stages.run(
        [prefix + "_edited.fa"], [bf_path, draft],
        f"ntedit polish -> {prefix}_edited.fa", engine,
    )
    if not args.dry_run:
        print("Done ntEdit!", flush=True)


def cmd_snv(args) -> None:
    if bool(args.reads) == bool(args.genome):
        raise SystemExit("Please specify --reads OR --genome")
    reference = args.reference or args.draft
    if not reference:
        raise SystemExit("Please specify --reference")
    stages = Stages(args.force, args.dry_run)

    if args.reads:
        bf_path = _reads_filter_stages(
            stages, args.reads, args.k, args.cutoff, args.solid, args.e,
        )
        prefix = f"{args.reads}_ntedit_k{args.k}"
    else:
        from ntedit_tpu.core import bfbuild

        genome_prefix = os.path.basename(args.genome[0]).split(".")[0]
        hist_path = f"{genome_prefix}.k{args.k}.hist"
        bf_path = f"{genome_prefix}_k{args.k}.bf"

        def make_hist():
            bfbuild.count_histogram(args.genome, args.k).save(hist_path)

        stages.run([hist_path], list(args.genome),
                   f"ntcard-role genome histogram -> {hist_path}", make_hist)

        def make_bf():
            hist = bfbuild.Histogram.load(hist_path, k=args.k)
            bf = bfbuild.build_genome_bf(
                args.genome, args.k, num_elements=hist.f0
            )
            bf.save(bf_path)

        stages.run([bf_path], list(args.genome) + [hist_path],
                   f"genome BF -> {bf_path}", make_bf)
        prefix = f"{genome_prefix}_ntedit_k{args.k}"

    def engine():
        _run_engine(
            bf_path, reference, prefix, vcf_path=args.l, threads=args.t,
            z=args.z, y=args.y, X=args.X, Y=args.Y, j=args.j, s=1,
            v=int(args.v), spill=args.spill,
        )

    stages.run(
        [prefix + "_variants.vcf"], [bf_path, reference],
        f"ntedit snv -> {prefix}_variants.vcf", engine,
    )
    if not args.dry_run:
        print("Done ntEdit!", flush=True)


def cmd_engine(args) -> None:
    if getattr(args, "c", None) is not None:
        print(
            "warning: -c has no effect (the v2.1.1 engine overrides the "
            "insertion cap to k*1.5; see FIDELITY.md #7)",
            file=sys.stderr, flush=True,
        )
    _run_engine(
        args.r, args.f, args.b, reject_path=args.e_bf, vcf_path=args.l,
        threads=args.t, z=args.z, i=args.i, d=args.d, x=args.x, y=args.y,
        X=args.X, Y=args.Y, j=args.j, m=args.m, s=args.s, a=args.a,
        v=args.v, p=args.p, q=args.q, spill=getattr(args, "spill", "auto"),
    )


def cmd_make_genome_bf(args) -> None:
    from ntedit_tpu.core import bfbuild
    from ntedit_tpu.io import fastx

    if args.num_elements is None and args.bf is None:
        print(f"Genome size (bp): {fastx.total_length(args.genome)}",
              flush=True)
    bf = bfbuild.build_genome_bf(
        args.genome, args.k, fpr=args.fpr, hash_num=args.hashes,
        bf_bytes=args.bf, num_elements=args.num_elements,
    )
    bf.save(args.o)
    print(f"Bloom filter saved to {args.o} ({bf.bytes} bytes)", flush=True)


# ---------------------------------------------------------------------------
# argparse wiring
# ---------------------------------------------------------------------------

def _add_common(sp) -> None:
    sp.add_argument("-k", type=int, required=True, help="k-mer size, REQUIRED")
    sp.add_argument("-l", type=str, default=None,
                    help="input VCF with annotated variants (e.g. clinvar.vcf)")
    sp.add_argument("--cutoff", type=int, default=2,
                    help="min k-mer coverage in output BF [2; ignored if --solid]")
    sp.add_argument("--solid", action="store_true",
                    help="keep only solid (non-erroneous) k-mers")
    sp.add_argument("-t", type=int, default=4, help="threads [4]")
    sp.add_argument("-z", type=int, default=100, help="min contig length [100]")
    sp.add_argument("--spill", choices=("auto", "on", "off"), default="auto",
                    help="per-contig record spill for crash-safe resume "
                         "[auto: on for drafts > 256 MB uncompressed; "
                         ".gz estimated via the gzip trailer]")
    sp.add_argument("-y", type=float, default=9.0, help="k/y present ratio [9.0]")
    sp.add_argument("-j", type=int, default=3, help="k-mer subset stride [3]")
    sp.add_argument("-X", type=float, default=-1.0,
                    help="missing-ratio alternative (0.5 if only -Y given)")
    sp.add_argument("-Y", type=float, default=-1.0,
                    help="present-ratio alternative (0.5 if only -X given)")
    sp.add_argument("-e", type=float, default=0.01,
                    help="false positive rate for the read Bloom filter [0.01]")
    sp.add_argument("-v", action="store_true", help="verbose")
    sp.add_argument("-V", "--version", action="version", version=VERSION)
    sp.add_argument("-n", "--dry-run", action="store_true",
                    help="print the stages that would run")
    sp.add_argument("-f", "--force", action="store_true",
                    help="run all steps regardless of existing outputs")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ntedit_tpu",
        description="ntEdit on a GPU: fast, scalable genome sequence polishing "
                    "and SNV detection & annotation",
    )
    sub = ap.add_subparsers(dest="mode")

    pol = sub.add_parser("polish", help="polish a draft assembly")
    pol.add_argument("--draft", required=True,
                     help="draft genome assembly (FASTA/.gz), REQUIRED")
    pol.add_argument("--reads", required=True,
                     help="prefix of reads file(s) in the working directory")
    pol.add_argument("-i", type=int, default=5, choices=range(0, 6),
                     help="max insertion bases to try [5]")
    pol.add_argument("-d", type=int, default=5, choices=range(0, 11),
                     help="max deletion bases to try [5]")
    pol.add_argument("-x", type=float, default=5.0,
                     help="k/x missing ratio [5.0]")
    pol.add_argument("--cap", type=float, default=None,
                     help="insertion cap [k*1.5]")
    pol.add_argument("-m", type=int, default=0, choices=range(0, 3),
                     help="edit mode: 0 first indel / 1 best indel / 2 best overall")
    pol.add_argument("-a", type=int, default=0, choices=range(0, 2),
                     help="soft-mask unfixed missing-kmer positions")
    pol.add_argument("-b", type=str, default="", help="output file prefix")
    pol.add_argument("--cbf", action="store_true",
                     help="use a counting Bloom filter (pipeline ntedit_cbf target)")
    pol.add_argument("-p", type=int, default=1,
                     help="min k-mer coverage threshold (CBF only) [1]")
    pol.add_argument("-q", type=int, default=255,
                     help="max k-mer coverage threshold (CBF only) [255]")
    _add_common(pol)
    pol.set_defaults(func=cmd_polish)

    snv = sub.add_parser("snv", help="call SNVs against a reference")
    snv.add_argument("--reference", help="reference assembly for SNV calling")
    snv.add_argument("--draft", help=argparse.SUPPRESS)
    snv.add_argument("--reads", type=str, default=None,
                     help="prefix of reads file(s) for variant calling")
    snv.add_argument("--genome", nargs="+", default=None,
                     help="genome assembly file(s) for detecting SNV on --reference")
    _add_common(snv)
    snv.set_defaults(func=cmd_snv)

    eng = sub.add_parser(
        "engine", help="run the engine directly on an existing Bloom filter"
    )
    eng.add_argument("-r", required=True, help="Bloom filter (.bf/.cbf), REQUIRED")
    eng.add_argument("-f", required=True, help="draft FASTA(.gz), REQUIRED")
    eng.add_argument("-b", default=None, help="output prefix [auto-composed]")
    eng.add_argument("-e", dest="e_bf", default=None,
                     help="secondary reject Bloom filter (repeat k-mers)")
    eng.add_argument("-t", type=int, default=4)
    eng.add_argument("-z", type=int, default=100)
    eng.add_argument("-i", type=int, default=5)
    eng.add_argument("-d", type=int, default=5)
    eng.add_argument("-x", type=float, default=5.0)
    eng.add_argument("-y", type=float, default=9.0)
    eng.add_argument("-X", type=float, default=-1.0)
    eng.add_argument("-Y", type=float, default=-1.0)
    eng.add_argument("-c", type=float, default=None,
                     help="insertion cap (overridden to k*1.5, as in v2.1.1)")
    eng.add_argument("-j", type=int, default=3)
    eng.add_argument("-m", type=int, default=0, choices=range(0, 3))
    eng.add_argument("-s", type=int, default=0, choices=range(0, 2))
    eng.add_argument("-l", default=None)
    eng.add_argument("-a", type=int, default=0, choices=range(0, 2))
    eng.add_argument("-v", type=int, default=0, choices=range(0, 2))
    eng.add_argument("-p", type=int, default=1)
    eng.add_argument("-q", type=int, default=255)
    eng.add_argument("--spill", choices=("auto", "on", "off"), default="auto",
                     help="per-contig record spill for crash-safe resume "
                          "[auto: on for drafts > 256 MB uncompressed; "
                          ".gz estimated via the gzip trailer]")
    eng.set_defaults(func=cmd_engine)

    mgb = sub.add_parser("make-genome-bf", help="build a Bloom filter from genomes")
    mgb.add_argument("--genome", nargs="+", required=True)
    mgb.add_argument("-k", type=int, required=True)
    mgb.add_argument("--fpr", type=float, default=0.01)
    mgb.add_argument("--hashes", type=int, default=3)
    mgb.add_argument("-o", default="genome_bf.bf")
    mgb.add_argument("--bf", type=int, default=None,
                     help="Bloom filter size in bytes")
    mgb.add_argument("--num_elements", type=int, default=None)
    mgb.add_argument("-t", type=int, default=12)
    mgb.set_defaults(func=cmd_make_genome_bf)

    return ap


def main(argv=None) -> None:
    # multi-host join must precede every other JAX call in the process
    # (parallel.distributed.initialize docstring); unset env -> no-op
    from ntedit_tpu.parallel import distributed as dist

    dist.initialize_from_env()
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mode is None:
        ap.print_help()
        sys.exit(0)
    args.func(args)


if __name__ == "__main__":
    main()
