#!/usr/bin/env python3
"""Benchmark: polish/SNV throughput on one GPU vs the UNMODIFIED
reference engine, with byte-identity asserts.

Structure (round-5 redesign — every lesson from the r04 timeout applied):

* **Incremental capture**: the orchestrator prints the MERGED headline
  record to stdout after EVERY completed section, so a timeout at any
  point costs only the tail sections, never the capture.  The last JSON
  line on stdout is always the most complete record.
* **Persistent corpus cache** (~/.cache/ntedit_tpu/bench): simulated
  drafts, device-built filters (blocked layout as .npy for us, plain
  btllib layout as ready-to-use .bf files for the C++ engines), and the
  FASTA artifacts are built once and reused across sections AND rounds
  (cold 250 Mbp setup is minutes; warm is seconds + one filter upload).
* **Acceptance-first ordering**: 250 Mbp (the BASELINE.md >10x regime,
  full-length live reference denominator) runs immediately after the
  identity section, BEFORE the 50 Mbp and 3 Gbp sections.
* **Card identity**: each section records the GPU's name and power limit
  (nvidia-smi), so numbers from differently capped cards are told apart.
* **Global deadline**: NTEDIT_BENCH_BUDGET seconds (default 2300);
  sections that do not fit the remaining budget are skipped and listed
  in the record.  The bench exits 0 with a parseable record regardless.

Sections (each runnable standalone, each isolated in a subprocess by the
orchestrator so a failed attempt poisons one section, not the run):
  --ecoli-only  4.7 Mbp identity + throughput; REAL E. coli draft
                (reference demo sequence) polished and byte-diffed
                against the unmodified reference binary.
  --giant-only  250 Mbp, 1 GiB device-built filter, live FULL-LENGTH
                reference denominator -> vs_reference_engine (headline).
  --snv-only    250 Mbp SNV mode (the reference's at-scale marquee mode,
                /root/reference/README.md:48-49) with a live reference
                -s 1 denominator on a 25 Mbp slice (per-base ratio
                labeled _extrapolated).
  --human-only  3 Gbp over 24 contigs, 4 GiB on-device-built filter;
                reference denominator on the first 250 Mbp (labeled
                _extrapolated per ADVICE r4).
  --scale-only  50 Mbp + scalar C++ baseline + sharded D=1 timing.

Denominator contract (VERDICT r4): the engine at
/root/reference/ntedit.cpp:2276 (compiled unmodified against the btllib
shim, native/Makefile) run `-t 4` on the SAME artifacts.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_BASES_PER_SEC = 6.0e6  # documented estimate; see module docstring
ECOLI_LEN = 4_708_041
K = 25
HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(
    os.environ.get("NTEDIT_BENCH_CACHE",
                   os.path.expanduser("~/.cache/ntedit_tpu")), "bench")
MINI = os.environ.get("NTEDIT_BENCH_MINI") == "1"  # CPU shakeout shapes
REAL_ECOLI = "/root/reference/demo/ecoliWithMismatches001Indels0001.fa.gz"
_CACHE_VERSION = 1


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def emit(rec):
    """One JSON record line on stdout (the driver parses the LAST one)."""
    print(json.dumps(rec), flush=True)


def measured_cpp_baseline(key: str = "bases_per_sec"):
    path = os.path.join(HERE, "native", "baseline.json")
    if os.path.exists(path):
        try:
            with open(path) as f:
                return float(json.load(f)[key])
        except Exception:
            return None
    return None


def ensure_native(targets=("ntedit_baseline", "reference_ntedit",
                           "libntedit_repair.so", "libntpu_io.so")):
    """Binaries are no longer version-controlled; build them on demand."""
    for tgt in targets:
        try:
            subprocess.run(["make", "-C", os.path.join(HERE, "native"), tgt],
                           check=False, capture_output=True, timeout=240)
        except Exception:
            pass


def residual_census(edited: bytes, truth: bytes, window: int = 30,
                    max_skew: int = 12):
    """Classify every locus where the polished sequence still differs from
    the truth: resynchronizing walk, one site per divergence."""
    sites = []
    i = j = 0
    E, T = edited, truth
    while i < len(E) and j < len(T):
        if E[i] == T[j]:
            i += 1
            j += 1
            continue
        found = None
        for d in range(1, 2 * max_skew + 2):
            for di in range(min(d, max_skew) + 1):
                dj = d - di
                if dj > max_skew:
                    continue
                if E[i + di : i + di + window] == T[j + dj : j + dj + window]:
                    found = (di, dj)
                    break
            if found:
                break
        if found is None:
            sites.append({"truth_pos": j, "kind": "desync"})
            break
        di, dj = found
        kind = "sub" if di == dj else ("extra_bases" if di > dj else "missing_bases")
        sites.append({
            "truth_pos": j, "kind": kind,
            "edited": E[i : i + di].decode(), "truth": T[j : j + dj].decode(),
        })
        i += di
        j += dj
    if i < len(E) or j < len(T):
        sites.append({"truth_pos": j, "kind": "tail_len_diff",
                      "extra": len(E) - i, "missing": len(T) - j})
    return sites


def require_gpu() -> None:
    """Fail the section unless JAX runs on a GPU: a device metric taken on
    another backend is not a device metric.  NTEDIT_BENCH_MINI=1 (CPU
    shakeout shapes) is the one exception and runs on the CPU."""
    import jax

    if MINI:
        jax.config.update("jax_platforms", "cpu")
        return
    if jax.default_backend() != "gpu":
        log(f"# section failed: JAX backend is {jax.default_backend()!r}, "
            "not 'gpu'")
        raise SystemExit(1)


def gpu_info():
    """The card's name and power limit as nvidia-smi reports them, kept
    beside every number (a card below its 700 W maximum runs slower)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


# ---------------------------------------------------------------------------
# Chunked device transfers (a sequence of 256 MiB pieces instead of one
# multi-GiB transfer; progress is visible per piece)
# ---------------------------------------------------------------------------

def _download_words(words_dev, piece: int = 1 << 26):
    n = words_dev.shape[0]
    out = np.empty(n, dtype=np.uint32)
    for s in range(0, n, piece):
        e = min(n, s + piece)
        out[s:e] = np.asarray(words_dev[s:e])
        if n > piece:
            log(f"#   download {e * 4 >> 20}/{n * 4 >> 20} MiB")
    return out


def _upload_words(host_words: np.ndarray, piece: int = 1 << 26):
    """Chunked host->device upload into one preallocated device array
    (donated dynamic_update_slice: no 2x HBM peak for 4 GiB filters)."""
    import jax
    import jax.numpy as jnp

    n = host_words.shape[0]
    if n <= piece:
        return jnp.asarray(host_words)
    put = jax.jit(
        lambda buf, p, off: jax.lax.dynamic_update_slice(buf, p, (off,)),
        donate_argnums=(0,),
    )
    buf = jnp.zeros(n, dtype=host_words.dtype)
    pad = np.zeros(piece, dtype=host_words.dtype)
    for s in range(0, n, piece):
        e = min(n, s + piece)
        chunk = host_words[s:e]
        if e - s < piece:  # one compiled shape
            pad[: e - s] = chunk
            pad[e - s :] = 0
            chunk = pad
            s = n - piece  # overlap is fine: trailing region rewritten
        buf = put(buf, jnp.asarray(chunk), np.int64(s))
        log(f"#   upload {e * host_words.itemsize >> 20}/"
            f"{n * host_words.itemsize >> 20} MiB")
    buf.block_until_ready()
    return buf


# ---------------------------------------------------------------------------
# Persistent corpus + filter cache
# ---------------------------------------------------------------------------

def _corpus_dir(name: str) -> str:
    return os.path.join(CACHE, name)


def _corpus_ready(name: str, want_meta: dict) -> bool:
    mp = os.path.join(_corpus_dir(name), "meta.json")
    if not os.path.exists(mp):
        return False
    try:
        with open(mp) as f:
            meta = json.load(f)
    except Exception:
        return False
    return all(meta.get(k) == v for k, v in want_meta.items())


def build_scale_corpus(name: str, contig_lens, seeds, nbits: int,
                       plain_too: bool = True, write_fasta_contigs: int = 0):
    """Simulated draft contigs + device-built filter(s), persisted.

    Per contig: truth = random genome, draft = truth + injected errors at
    the reference demo's rates (README.md:333).  The filter holds the
    TRUTH k-mers (infinite-coverage limit of the read filter).  Builds
    the framework-native blocked layout and (plain_too) the btllib plain
    layout in the SAME pass over the truth stream; persists:
      draft_c{i}.npy   uint8 drafts
      blocked.npy      uint32 blocked filter words
      t.bf             plain-layout btllib file (C++ engines load as-is)
      d.fa             FASTA of the first `write_fasta_contigs` contigs
      meta.json        written LAST = atomic done marker
    """
    from ntedit_tpu.core import bfbuild, bloom
    from ntedit_tpu.utils import simulate

    d = _corpus_dir(name)
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    bb = bfbuild.DeviceFilterBuilder(K, 3, nbits, 1 << 10)
    pb = (bfbuild.DeviceFilterBuilder(K, 3, nbits, 1 << 10, layout="plain")
          if plain_too else None)
    # MINI (CPU shakeout): the production 16 Mbp insert batch is padded to
    # full shape, and the CPU sort-based scatter takes minutes per batch
    B = (1 << 20) if MINI else bfbuild._DEV_BATCH
    for c, (clen, seed) in enumerate(zip(contig_lens, seeds)):
        truth = simulate.random_genome(clen, seed=seed)
        draft, _ = simulate.inject_errors(
            truth, sub_rate=1e-3, ins_rate=1e-4, del_rate=1e-4,
            seed=seed + 1,
        )
        np.save(os.path.join(d, f"draft_c{c}.npy"), draft)
        for s in range(0, clen, B):
            # pad the tail batch to the uniform shape: ONE compiled insert
            # program per layout; pad bytes 0x00 = invalid windows
            chunk = truth[s : min(clen, s + B + K - 1)]
            if len(chunk) < B + K - 1:
                chunk = np.concatenate(
                    [chunk, np.zeros(B + K - 1 - len(chunk), np.uint8)])
            enc = bb.encode_batch(chunk)
            bb.insert_batch(enc, 1)
            if pb is not None:
                pb.insert_batch(enc, 1)
        del truth
        log(f"# corpus {name}: contig {c + 1}/{len(contig_lens)} built "
            f"({time.time() - t0:.0f}s)")
    words_dev = bb.device_words()
    host_words = _download_words(words_dev)
    bb.words = None
    np.save(os.path.join(d, "blocked.npy"), host_words)
    if pb is not None:
        plain_words = _download_words(pb.device_words())
        pb.words = None
        plain = bloom.KmerBloomFilter(plain_words.view(np.uint8), 3, K)
        plain.save(os.path.join(d, "t.bf"))
        del plain, plain_words
    if write_fasta_contigs:
        with open(os.path.join(d, "d.fa"), "w") as f:
            for c in range(min(write_fasta_contigs, len(contig_lens))):
                draft = np.load(os.path.join(d, f"draft_c{c}.npy"))
                f.write(f">chr{c + 1}\n" + draft.tobytes().decode() + "\n")
    meta = {"version": _CACHE_VERSION, "k": K, "nbits": nbits,
            "contig_lens": list(map(int, contig_lens)),
            "seeds": list(map(int, seeds)), "plain": bool(plain_too),
            "fasta_contigs": int(write_fasta_contigs)}
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    log(f"# corpus {name}: built + persisted in {time.time() - t0:.0f}s "
        f"({d})")
    return words_dev, host_words


def get_corpus(name: str, contig_lens, seeds, nbits: int,
               plain_too: bool = True, write_fasta_contigs: int = 0):
    """Load (building if absent) a cached corpus.  Returns a dict with
    drafts (list of uint8 arrays), blocked host filter, blocked DeviceFilter
    (device words uploaded or reused from the build), and artifact paths."""
    from ntedit_tpu.core import bloom

    want = {"version": _CACHE_VERSION, "k": K, "nbits": nbits,
            "contig_lens": list(map(int, contig_lens)),
            "seeds": list(map(int, seeds)), "plain": bool(plain_too),
            "fasta_contigs": int(write_fasta_contigs)}
    d = _corpus_dir(name)
    t0 = time.time()
    if _corpus_ready(name, want):
        host_words = np.load(os.path.join(d, "blocked.npy"))
        words_dev = _upload_words(host_words)
        log(f"# corpus {name}: warm cache load + filter upload "
            f"{time.time() - t0:.1f}s")
    else:
        words_dev, host_words = build_scale_corpus(
            name, contig_lens, seeds, nbits, plain_too, write_fasta_contigs)
    drafts = [np.load(os.path.join(d, f"draft_c{c}.npy"))
              for c in range(len(contig_lens))]
    blocked = bloom.BlockedKmerBloomFilter(host_words, 3, K)
    df = bloom.DeviceFilter(words_dev, None, nbits, 0, 3, K, False,
                            blocked=True)
    return {
        "drafts": drafts, "blocked": blocked, "df": df,
        "fa": os.path.join(d, "d.fa") if write_fasta_contigs else None,
        "bf": os.path.join(d, "t.bf") if plain_too else None,
        "dir": d,
    }


def _slice_fasta(corpus_dir: str, out_name: str, n_bases: int) -> str:
    """FASTA of the first n_bases of contig 0, cached alongside the
    corpus (reference SNV denominator slice)."""
    out = os.path.join(corpus_dir, out_name)
    if not os.path.exists(out):
        draft = np.load(os.path.join(corpus_dir, "draft_c0.npy"))
        with open(out, "w") as f:
            f.write(">chr1\n" + draft[:n_bases].tobytes().decode() + "\n")
    return out


def _time_binary(cmd, runs: int):
    """Median wall-clock of `runs` executions (live denominator: this
    host's CPU speed varies run to run)."""
    times = []
    for _ in range(runs):
        t = time.time()
        subprocess.run(cmd, check=True, capture_output=True)
        times.append(time.time() - t)
    return sorted(times)[len(times) // 2]


def _ref_bin():
    p = os.path.join(HERE, "native", "reference_ntedit")
    if not os.path.exists(p):
        ensure_native(("reference_ntedit",))
    return p if os.path.exists(p) else None


# ---------------------------------------------------------------------------
# Section: --ecoli-only  (identity + 4.7 Mbp throughput + REAL E. coli)
# ---------------------------------------------------------------------------

def main():
    require_gpu()
    ensure_native()
    from ntedit_tpu.core import bloom
    from ntedit_tpu.engine import native_repair, wavefront
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.polish import Polisher
    from ntedit_tpu.utils import simulate

    health = gpu_info()
    t0 = time.time()
    ecoli_len = 1 << 20 if MINI else ECOLI_LEN
    truth = simulate.random_genome(ecoli_len, seed=42)
    draft, injected = simulate.inject_errors(
        truth, sub_rate=1e-3, ins_rate=1e-4, del_rate=1e-4, seed=43
    )
    # framework-native blocked filter: power-of-two sizing, one gather
    # per probe (see bloom.BlockedKmerBloomFilter)
    nbytes = bloom.pow2_size_bytes(ecoli_len, 3, 0.001)
    bf = bloom.BlockedKmerBloomFilter.zeros(nbytes, 3, K)
    bf.insert_seq(truth)
    log(f"# setup {time.time() - t0:.1f}s: draft {len(draft)} bp, "
        f"{len(injected)} injected errors, BF {nbytes >> 20} MiB")

    cfg = EngineConfig(k=K, hash_num=3)
    pol = Polisher(bf, None, cfg)
    native_ok = native_repair.available()
    log(f"# repair engine: {pol.engine} (native lib: {native_ok})")

    # warmup (compile) with the production chunk shape
    warm = pol.gate_positions(draft)
    log(f"# warmup gates: {len(warm)}")

    # --- timed runs: median of 5 (medians on BOTH sides keep the
    # headline within noise run over run) ---
    times = []
    for _ in range(5):
        t1 = time.time()
        res = pol.polish_contig("ecoli_sim", draft)
        times.append(time.time() - t1)
    dt = sorted(times)[2]
    bases_per_sec = len(draft) / dt

    # stage costs measured unoverlapped (the pipelined path overlaps them)
    t1 = time.time()
    hint = pol.gate_positions(draft)
    stage_gate = time.time() - t1
    stage_repair = 0.0
    if native_ok:
        t1 = time.time()
        _ = native_repair.polish_contig_segmented(
            pol.oracle.bloom, None, cfg, "ecoli_sim", draft, hint,
            threads=cfg.threads,
        )
        stage_repair = time.time() - t1
    log(f"# stages unoverlapped: gate pass {stage_gate*1e3:.0f}ms, "
        f"threaded repair {stage_repair*1e3:.0f}ms; pipelined total "
        f"{dt*1e3:.0f}ms ({bases_per_sec:,.0f} bp/s)")

    # --- engine identity at full scale: native == wavefront; plus the
    # sequential spec oracle directly on a 1 Mbp slice (the full-contig
    # oracle run takes ~21 s and is covered transitively: wavefront ==
    # oracle is property-tested, and a full-scale run verified identical
    # once — see PERF.md) ---
    t4 = time.time()
    res_wf = wavefront.polish_contig_wavefront(
        pol.oracle, "ecoli_sim", bytes(draft), hint
    )
    identical = (res.edited == res_wf.edited and res.subs == res_wf.subs)
    log(f"# identity: native == wavefront: {identical} "
        f"(wavefront {time.time()-t4:.2f}s, edits={len(res.subs)})")
    sl0 = min(1_000_000, ecoli_len)
    hint0 = hint[hint < sl0 - K]
    res_or = pol.oracle.polish_contig("s", bytes(draft[:sl0]), gate_hint=hint0)
    if native_ok:
        res_sl = native_repair.polish_contig_native(
            pol.oracle.bloom, None, cfg, "s", draft[:sl0], gate_hint=hint0)
        identical_oracle = (
            res_sl is not None
            and res_sl.edited == res_or.edited and res_sl.subs == res_or.subs
        )
        log(f"# identity: native == sequential oracle (1 Mbp direct): "
            f"{identical_oracle}")
    else:
        res_wf0 = wavefront.polish_contig_wavefront(
            pol.oracle, "s", bytes(draft[:sl0]), hint0)
        identical_oracle = (
            res_wf0.edited == res_or.edited and res_wf0.subs == res_or.subs
        )
        log(f"# identity: wavefront == sequential oracle (1 Mbp direct, "
            f"no native lib): {identical_oracle}")

    # --- residual-error census: why edited != truth ---
    correct = res.edited == truth.tobytes()
    census = residual_census(res.edited, truth.tobytes())
    kinds = {}
    for s in census:
        kinds[s["kind"]] = kinds.get(s["kind"], 0) + 1
    log(f"# correct={correct}: {len(injected)} injected errors, "
        f"{len(res.subs)} sub records, {len(census)} residual sites {kinds}")
    for s in census[:3]:
        log(f"#   residual example: {s}")
    # residuals are sites where mode-0 took the first qualifying indel
    # instead of the true one, or BF FPs masked the error (the reference
    # engine has the same failure modes)

    # --- three-way output identity on the SAME btllib-layout filter:
    # C++ scalar baseline == native repair == wavefront, baseline TIMED
    # live (median of 3) ---
    three_way = None
    baseline_live = None
    binary = os.path.join(HERE, "native", "ntedit_baseline")
    if os.path.exists(binary):
        pbf = bloom.KmerBloomFilter.zeros(nbytes, 3, K)
        pbf.insert_seq(truth)
        with tempfile.TemporaryDirectory() as td:
            fa = os.path.join(td, "d.fa")
            with open(fa, "w") as f:
                f.write(">c\n" + draft.tobytes().decode() + "\n")
            bfp = os.path.join(td, "t.bf")
            pbf.save(bfp)
            ed = os.path.join(td, "edited.txt")
            runs = []
            for _ in range(3):
                out = subprocess.check_output([binary, fa, bfp, ed]).decode()
                runs.append(json.loads(out))
            base_stats = sorted(runs, key=lambda r: r["seconds"])[1]
            baseline_live = float(base_stats["bases_per_sec"])
            with open(ed, "rb") as f:
                base_edited = f.read().rstrip(b"\n")
        from ntedit_tpu.core import nthash_ref as nh

        cfgp = EngineConfig(k=K, hash_num=3)
        polp = Polisher(pbf, None, cfgp, use_device=False)
        o = polp.oracle
        rn = (
            native_repair.polish_contig_native(o.bloom, None, cfgp, "c", draft)
            if native_ok else None
        )
        fh, rh = nh.all_window_hashes(draft, K)
        hs = nh.extend_hashes_vec(nh.canonical(fh, rh), K, 3)
        gates = np.nonzero(~pbf.contains_hashes(hs))[0]
        rw = wavefront.polish_contig_wavefront(o, "c", bytes(draft), gates)
        three_way = (
            rn is not None and rn.edited == rw.edited == base_edited
            if native_ok else rw.edited == base_edited
        )
        log(f"# three-way identity (plain BF): baseline.cpp == native == "
            f"wavefront: {three_way} (baseline {base_stats['seconds']}s = "
            f"{baseline_live:,.0f} bp/s live)")

    # --- REAL E. coli sequence (VERDICT r4 missing #2): the reference
    # demo's actual 4.7 Mbp draft as truth, errors injected at the demo's
    # documented rates, filter from ITS k-mers; framework output
    # byte-diffed against the unmodified reference binary.  Real repeats
    # and low-complexity runs exercise the KMP insertion rollback
    # (ntedit.cpp:1312-1380) and indel cascades that uniform-random
    # corpora cannot. ---
    real = real_census = None
    real_bp_per_sec = None
    try:
        real = run_real_ecoli()
        if real is not None:
            real_bp_per_sec = real["bp_per_sec"]
            real_census = real["census_kinds"]
    except Exception as exc:
        log(f"# real-ecoli subsection failed: {exc}")

    # --- mode-family side benches (1 Mbp slices) ---
    snv_1m = cbf_1m = None
    try:
        from ntedit_tpu.core import nthash_ref as nh

        sl = min(1_000_000, ecoli_len)
        tr_s = truth[:sl]
        dr_s = draft[:sl]
        cfg_snv = EngineConfig(k=K, hash_num=3, snv=True)
        pol_snv = Polisher(bf, None, cfg_snv)
        rs = pol_snv.polish_contig("s", dr_s)  # warm (compile)
        t5 = time.time()
        rs = pol_snv.polish_contig("s", dr_s)
        snv_1m = round(sl / (time.time() - t5), 1)
        log(f"# 1 Mbp SNV: {snv_1m:,.0f} bp/s ({len(rs.subs)} records)")
        cbf = bloom.KmerCountingBloomFilter8.zeros(nbytes, 3, K)
        fh, rh = nh.all_window_hashes(tr_s, K)
        hs = nh.extend_hashes_vec(nh.canonical(fh, rh), K, 3)
        for _ in range(3):
            cbf.insert_hashes(hs)
        cfg_cbf = EngineConfig(k=K, hash_num=3, min_threshold=2)
        pol_cbf = Polisher(cbf, None, cfg_cbf)
        rc = pol_cbf.polish_contig("c", dr_s)  # warm (compile)
        t6 = time.time()
        rc = pol_cbf.polish_contig("c", dr_s)
        cbf_1m = round(sl / (time.time() - t6), 1)
        log(f"# 1 Mbp CBF polish: {cbf_1m:,.0f} bp/s ({len(rc.subs)} edits)")
    except Exception as exc:  # side benches must never sink the headline
        log(f"# mode-family benches skipped: {exc}")

    baseline = baseline_live or measured_cpp_baseline() or BASELINE_BASES_PER_SEC
    emit({
        "metric": "bases_polished_per_sec_chip_ecoli_k25",
        "value": round(bases_per_sec, 1),
        "unit": "bases/s",
        "vs_baseline": round(bases_per_sec / baseline, 3),
        "identical_to_wavefront": bool(identical),
        "identical_to_oracle": bool(identical_oracle),
        "three_way_identical": three_way,
        "real_ecoli_identical_to_reference": (
            real["identical"] if real else None),
        "real_ecoli_bp_per_sec": real_bp_per_sec,
        "real_ecoli_residual_kinds": real_census,
        "gate_ms": round(stage_gate * 1e3, 1),
        "repair_ms": round(stage_repair * 1e3, 1),
        "snv_1mbp_bp_per_sec": snv_1m,
        "cbf_1mbp_bp_per_sec": cbf_1m,
        "gpu": health,
    })


def run_real_ecoli():
    """Polish an error-injected copy of the REAL E. coli draft
    (/root/reference/demo/ecoliWithMismatches001Indels0001.fa.gz used as
    truth, errors injected at README.md:333 rates, filter from its
    k-mers) with BOTH engines; byte-diff the three output files.
    Returns {identical, bp_per_sec, census_kinds} or None if the real
    sequence / reference binary is unavailable."""
    from ntedit_tpu.core import bloom
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.polish import Polisher
    from ntedit_tpu.io import fastx
    from ntedit_tpu.utils import simulate

    if not os.path.exists(REAL_ECOLI):
        log("# real-ecoli: reference demo draft not found; skipped")
        return None
    ref_bin = _ref_bin()
    recs = list(fastx.read_fastx(REAL_ECOLI))
    truth = np.concatenate([r.seq for r in recs])
    if MINI:
        truth = truth[: 1 << 20]
    draft, injected = simulate.inject_errors(
        truth, sub_rate=1e-3, ins_rate=1e-4, del_rate=1e-4, seed=99)
    # plain btllib layout so BOTH engines probe the identical artifact
    nbytes = bloom.pow2_size_bytes(len(truth), 3, 0.001)
    pbf = bloom.KmerBloomFilter.zeros(nbytes, 3, K)
    pbf.insert_seq(truth)
    cfg = EngineConfig(k=K, hash_num=3)
    pol = Polisher(pbf, None, cfg)
    r = pol.polish_contig("U00096.3_draft", draft)  # warm
    t1 = time.time()
    r = pol.polish_contig("U00096.3_draft", draft)
    dt = time.time() - t1
    census = residual_census(r.edited, truth.tobytes())
    kinds = {}
    for s in census:
        kinds[s["kind"]] = kinds.get(s["kind"], 0) + 1
    log(f"# real-ecoli: {len(draft)} bp REAL sequence, {len(injected)} "
        f"injected, {len(r.subs)} records, {dt:.2f}s "
        f"({len(draft)/dt:,.0f} bp/s), residuals {kinds}")
    identical = None
    if ref_bin:
        with tempfile.TemporaryDirectory() as td:
            fa = os.path.join(td, "d.fa")
            with open(fa, "w") as f:
                f.write(">U00096.3_draft\n" + draft.tobytes().decode() + "\n")
            bfp = os.path.join(td, "t.bf")
            pbf.save(bfp)
            res = subprocess.run(
                [ref_bin, "-f", fa, "-r", bfp, "-b",
                 os.path.join(td, "ref"), "-t", "4"],
                capture_output=True, timeout=600)
            if res.returncode != 0:
                log(f"# real-ecoli: reference run failed rc={res.returncode}")
            else:
                from ntedit_tpu import cli as _cli

                ours = os.path.join(td, "ours")
                _cli.main(["engine", "-f", fa, "-r", bfp, "-b", ours,
                           "-t", "4"])
                identical = True
                for suffix in ("_edited.fa", "_changes.tsv"):
                    a = open(os.path.join(td, "ref" + suffix), "rb").read()
                    b = open(ours + suffix, "rb").read()
                    if a != b:
                        identical = False
                        log(f"# real-ecoli: {suffix} DIFFERS "
                            f"({len(a)} vs {len(b)} bytes)")
                va = _vcf_body(os.path.join(td, "ref_variants.vcf"))
                vb = _vcf_body(ours + "_variants.vcf")
                if va != vb:
                    identical = False
                    log("# real-ecoli: _variants.vcf DIFFERS")
                log(f"# real-ecoli: byte-identical to the UNMODIFIED "
                    f"reference binary: {identical}")
    return {"identical": identical, "bp_per_sec": round(len(draft) / dt, 1),
            "census_kinds": kinds}


def _vcf_body(path):
    with open(path) as f:
        return [ln for ln in f
                if not ln.startswith("##source=")
                and not ln.startswith("##fileDate=")]


# ---------------------------------------------------------------------------
# Section: --giant-only  (250 Mbp — the acceptance regime, run FIRST
# among the scale sections)
# ---------------------------------------------------------------------------

def giant_main():
    """250 Mbp single-contig polish (human-chromosome class), 1 GiB
    device-built filter, with the UNMODIFIED reference engine timed on
    the FULL corpus (1 run, -t 4) as the denominator of record.  This is
    the BASELINE.md acceptance number: vs_reference_engine >= 10."""
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.polish import Polisher

    require_gpu()
    ensure_native(("reference_ntedit",))
    health = gpu_info()
    SCALE = (1 << 23) if MINI else 250_000_000
    from ntedit_tpu.core import bloom as _bloom

    nbits = _bloom.pow2_size_bytes(SCALE, 3, 0.001) * 8
    t0 = time.time()
    corpus = get_corpus("g250m" if not MINI else "g_mini",
                        [SCALE], [72], nbits, plain_too=True,
                        write_fasta_contigs=1)
    draft = corpus["drafts"][0]
    cfg = EngineConfig(k=K, hash_num=3)
    pol = Polisher(corpus["blocked"], None, cfg, df=corpus["df"])
    log(f"# giant setup {time.time()-t0:.1f}s: 250 Mbp draft, "
        f"BF {nbits>>23} MiB blocked (+ plain twin on disk)")
    import resource

    r = pol.polish_contig("chr1", draft)  # warm
    times = []
    for _ in range(2):
        t1 = time.time()
        r = pol.polish_contig("chr1", draft)
        times.append(time.time() - t1)
    dt = min(times)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    log(f"# 250 Mbp polish: {dt:.2f}s ({SCALE/dt:,.0f} bp/s), "
        f"{len(r.subs)} records, peak RSS {rss:.1f} GB")

    ref = None
    ref_bin = _ref_bin()
    if ref_bin and corpus["fa"] and corpus["bf"]:
        try:
            with tempfile.TemporaryDirectory() as td:
                dt_ref = _time_binary(
                    [ref_bin, "-f", corpus["fa"], "-r", corpus["bf"], "-b",
                     os.path.join(td, "ref"), "-t", "4"], 1)
                ref = SCALE / dt_ref
                log(f"# 250 Mbp REFERENCE engine (unmodified ntedit.cpp, "
                    f"live, FULL length, 1 run, -t 4): {ref:,.0f} bp/s "
                    f"({dt_ref:.1f}s)")
        except Exception as exc:
            log(f"# 250 Mbp reference measurement skipped: {exc}")
    rec = {
        "metric": "bases_polished_per_sec_chip_250mbp_k25",
        "value": round(SCALE / dt, 1), "unit": "bases/s",
        "edits": len(r.subs),
        "wall_ms": round(dt * 1e3, 1),
        "peak_rss_gb": round(rss, 2),
        "gpu": health,
    }
    if ref:
        rec["vs_reference_engine"] = round(SCALE / dt / ref, 2)
        rec["reference_bp_per_sec"] = round(ref, 1)
        rec["vs_baseline"] = rec["vs_reference_engine"]
    else:
        rec["vs_baseline"] = round(
            SCALE / dt / (measured_cpp_baseline() or BASELINE_BASES_PER_SEC), 2)
    emit(rec)


# ---------------------------------------------------------------------------
# Section: --snv-only  (250 Mbp SNV — the reference's at-scale marquee
# mode; reuses the giant corpus + filter)
# ---------------------------------------------------------------------------

def snv_main():
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.polish import Polisher

    require_gpu()
    ensure_native(("reference_ntedit",))
    health = gpu_info()
    SCALE = (1 << 23) if MINI else 250_000_000
    REF_SLICE = (1 << 21) if MINI else 25_000_000
    from ntedit_tpu.core import bloom as _bloom

    nbits = _bloom.pow2_size_bytes(SCALE, 3, 0.001) * 8
    t0 = time.time()
    corpus = get_corpus("g250m" if not MINI else "g_mini",
                        [SCALE], [72], nbits, plain_too=True,
                        write_fasta_contigs=1)
    draft = corpus["drafts"][0]
    cfg = EngineConfig(k=K, hash_num=3, snv=True)
    pol = Polisher(corpus["blocked"], None, cfg, df=corpus["df"])
    log(f"# snv setup {time.time()-t0:.1f}s (shared g250m corpus)")
    r = pol.polish_contig("chr1", draft)  # warm
    times = []
    for _ in range(2):
        t1 = time.time()
        r = pol.polish_contig("chr1", draft)
        times.append(time.time() - t1)
    dt = min(times)
    log(f"# 250 Mbp SNV: {dt:.2f}s ({SCALE/dt:,.0f} bp/s), "
        f"{len(r.subs)} records")

    ref = None
    ref_bin = _ref_bin()
    if ref_bin and corpus["bf"]:
        try:
            fa_slice = _slice_fasta(corpus["dir"], "d_snv_slice.fa",
                                    REF_SLICE)
            with tempfile.TemporaryDirectory() as td:
                dt_ref = _time_binary(
                    [ref_bin, "-f", fa_slice, "-r", corpus["bf"], "-b",
                     os.path.join(td, "ref"), "-t", "4", "-s", "1"], 1)
                ref = REF_SLICE / dt_ref
                log(f"# SNV REFERENCE engine (-s 1, live, "
                    f"{REF_SLICE//1_000_000} Mbp slice, -t 4): "
                    f"{ref:,.0f} bp/s ({dt_ref:.1f}s)")
        except Exception as exc:
            log(f"# SNV reference measurement skipped: {exc}")
    rec = {
        "metric": "bases_snv_per_sec_chip_250mbp_k25",
        "value": round(SCALE / dt, 1), "unit": "bases/s",
        "records": len(r.subs),
        "wall_ms": round(dt * 1e3, 1),
        "gpu": health,
    }
    if ref:
        # per-base ratio; the reference rate comes from a slice (the
        # full-length -s 1 run alone would blow the section budget), so
        # the ratio is labeled extrapolated (ADVICE r4 #4 convention)
        rec["vs_reference_engine_extrapolated"] = round(SCALE / dt / ref, 2)
        rec["reference_bp_per_sec"] = round(ref, 1)
        rec["reference_timed_bp"] = REF_SLICE
        rec["vs_baseline"] = rec["vs_reference_engine_extrapolated"]
    else:
        rec["vs_baseline"] = 0.0
    emit(rec)


# ---------------------------------------------------------------------------
# Section: --human-only  (3 Gbp over 24 contigs, 4 GiB filter)
# ---------------------------------------------------------------------------

def human_main():
    """The stated north-star workload (BASELINE.md): 3 Gbp, 24-contig
    human-scale draft, 4 GiB (2^35-bit) filter built on the chip, polished
    contig-streamed; the unmodified reference engine timed live on the
    first 2 contigs (250 Mbp) of the SAME corpus/filter (a full 3 Gbp
    reference run is ~1 h on this 2-core host).  The per-base ratio is
    labeled _extrapolated (ADVICE r4 #4): it assumes the scalar engine's
    per-base rate at fixed filter size is scale-free."""
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.polish import Polisher

    require_gpu()
    ensure_native(("reference_ntedit",))
    health = gpu_info()
    if MINI:
        N_CONTIGS, CLEN, NBITS = 3, 1 << 20, 1 << 22
    else:
        N_CONTIGS, CLEN = 24, 125_000_000
        NBITS = 1 << 35  # 4 GiB: the SURVEY §5.8 human-read-set sizing
    TOTAL = N_CONTIGS * CLEN
    t0 = time.time()
    corpus = get_corpus("h3g" if not MINI else "h_mini",
                        [CLEN] * N_CONTIGS,
                        [5000 + c for c in range(N_CONTIGS)],
                        NBITS, plain_too=True, write_fasta_contigs=2)
    log(f"# human setup {time.time() - t0:.0f}s: {TOTAL / 1e9:.2f} Gbp "
        f"over {N_CONTIGS} contigs, filter 2^{NBITS.bit_length() - 1} bits "
        f"= {NBITS >> 33} GiB")
    import resource

    cfg = EngineConfig(k=K, hash_num=3)
    pol = Polisher(corpus["blocked"], None, cfg, df=corpus["df"])
    _ = pol.polish_contig(
        "warm", corpus["drafts"][0][: min(CLEN, 4_194_304) + K])  # compile
    t1 = time.time()
    edits = 0
    # serial per-contig loop ON PURPOSE: the two-deep overlapped stream
    # (pol.polish) measured SLOWER here (238.8 s vs 180.6 s, same warm
    # corpus) — on one device the interleaved dense dispatches of contig
    # c+1 queue between contig c's chunks and stall c's readback drain,
    # and 2x repair pools oversubscribe the 2-core host
    for c, draft in enumerate(corpus["drafts"]):
        r = pol.polish_contig(f"chr{c + 1}", draft)
        edits += len(r.subs)
        del r
    dt = time.time() - t1
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    log(f"# 3 Gbp polish: {dt:.1f}s ({TOTAL / dt:,.0f} bp/s), "
        f"{edits} records, peak RSS {rss:.1f} GB")

    ref = None
    ref_bp = 2 * CLEN
    ref_bin = _ref_bin()
    if ref_bin and corpus["fa"] and corpus["bf"]:
        try:
            with tempfile.TemporaryDirectory() as td:
                dt_ref = _time_binary(
                    [ref_bin, "-f", corpus["fa"], "-r", corpus["bf"], "-b",
                     os.path.join(td, "ref"), "-t", "4"], 1)
                ref = ref_bp / dt_ref
                log(f"# REFERENCE engine on 250 Mbp of the corpus (4 GiB "
                    f"filter, -t 4 over 2 contigs = both cores, 1 run): "
                    f"{ref:,.0f} bp/s ({dt_ref:.0f}s)")
        except Exception as exc:
            log(f"# human reference measurement skipped: {exc}")

    rec = {
        "metric": "bases_polished_per_sec_chip_3gbp_k25",
        "value": round(TOTAL / dt, 1), "unit": "bases/s",
        "edits": edits,
        "wall_ms": round(dt * 1e3, 1),
        "peak_rss_gb": round(rss, 2),
        "filter_bits_log2": NBITS.bit_length() - 1,
        "contigs": N_CONTIGS,
        "gpu": health,
    }
    if ref:
        rec["vs_reference_engine_extrapolated"] = round(TOTAL / dt / ref, 2)
        rec["reference_bp_per_sec"] = round(ref, 1)
        rec["reference_timed_bp"] = ref_bp
        rec["vs_baseline"] = rec["vs_reference_engine_extrapolated"]
    else:
        rec["vs_baseline"] = 0.0
    emit(rec)


# ---------------------------------------------------------------------------
# Section: --scale-only  (50 Mbp + scalar baseline + sharded D=1)
# ---------------------------------------------------------------------------

def scale_main():
    """50 Mbp scale section: framework vs BOTH live C++ denominators
    (scalar ntedit_baseline median-of-3 and the unmodified reference
    median-of-3, -t 4), plus the production sharded path on a 1-device
    mesh (byte-equality asserted) — the only multi-chip perf signal this
    environment can produce.  The device cand-mask A/B is opt-in
    (NTEDIT_BENCH_AB=1): it loses single-chip (r04: 3.88s vs 0.53s)."""
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.polish import Polisher

    require_gpu()
    ensure_native()
    health = gpu_info()
    SCALE = (1 << 23) if MINI else 50_000_000
    from ntedit_tpu.core import bloom as _bloom

    nbits = _bloom.pow2_size_bytes(SCALE, 3, 0.001) * 8
    t7 = time.time()
    corpus = get_corpus("s50m" if not MINI else "s_mini",
                        [SCALE], [52], nbits, plain_too=True,
                        write_fasta_contigs=1)
    draft50 = corpus["drafts"][0]
    bf50, df50 = corpus["blocked"], corpus["df"]
    cfg = EngineConfig(k=K, hash_num=3)
    pol50 = Polisher(bf50, None, cfg, df=df50)
    log(f"# scale setup {time.time()-t7:.1f}s: 50 Mbp draft, "
        f"BF {nbits>>23} MiB blocked (+ plain twin on disk)")
    r50 = pol50.polish_contig("chr", draft50)  # warm
    t50 = []
    for _ in range(3):
        t8 = time.time()
        r50 = pol50.polish_contig("chr", draft50)
        t50.append(time.time() - t8)
    dt50 = sorted(t50)[1]

    # packed-draft cache A/B (VERDICT r4 #6): warm runs skip the host
    # 2-bit encode AND the H2D upload entirely (content-fingerprint
    # cache, flag.packed_device); measure the term it removes
    enc_cold = enc_warm = None
    try:
        from ntedit_tpu.engine import flag as _flagm

        n50 = len(draft50) - K + 1
        ec = _flagm._effective_chunk(n50, _flagm.DEFAULT_CHUNK)
        _flagm._PACK_CACHE.clear()
        t8 = time.time()
        p, _e = _flagm.packed_device(draft50, n50, K, ec)
        p.block_until_ready()
        enc_cold = time.time() - t8
        t8 = time.time()
        p, _e = _flagm.packed_device(draft50, n50, K, ec)
        enc_warm = time.time() - t8
        log(f"# 50 Mbp packed-draft encode+upload: {enc_cold:.3f}s cold, "
            f"{enc_warm*1e3:.1f} ms cached (warm runs exclude the upload)")
    except Exception as exc:
        log(f"# pack-cache A/B skipped: {exc}")

    # opt-in device candidate-mask A/B (loses single-chip; kept measurable)
    dt_cand = dt_seg0 = None
    if os.environ.get("NTEDIT_BENCH_AB") == "1":
        try:
            from ntedit_tpu.engine import flag as _flag
            from ntedit_tpu.engine import native_repair as _nr

            hint50 = pol50.gate_positions(draft50)
            _flag.polish_candidate_masks(draft50, df50, hint50)  # warm
            t8 = time.time()
            masks = _flag.polish_candidate_masks(draft50, df50, hint50)
            r_cand = _nr.polish_contig_segmented(
                bf50, None, cfg, "chr", bytes(draft50), hint50,
                threads=cfg.threads, gate_cand=masks)
            dt_cand = time.time() - t8
            t9 = time.time()
            r_seg0 = _nr.polish_contig_segmented(
                bf50, None, cfg, "chr", bytes(draft50), hint50,
                threads=cfg.threads)
            dt_seg0 = time.time() - t9
            same = (r_cand is not None and r_seg0 is not None
                    and r_cand.edited == r50.edited == r_seg0.edited)
            log(f"# 50 Mbp segmented repair: {dt_seg0:.2f}s plain vs "
                f"{dt_cand:.2f}s with device cand-masks (identical: {same})")
            if not same:
                dt_cand = dt_seg0 = None
        except Exception as exc:
            log(f"# cand-mask A/B skipped: {exc}")

    # production sharded path, 1-device mesh: the multi-chip code path
    # timed on the real chip, byte-equal asserted (VERDICT r4 #4 target:
    # within 2x of the Polisher wall)
    dt_sh = None
    try:
        from ntedit_tpu.parallel import mesh as pmesh

        mesh1 = pmesh.make_mesh(1)
        r_sh = pmesh.sharded_polish(
            mesh1, "chr", draft50, bf50, df50.words, cfg)
        t8 = time.time()
        r_sh = pmesh.sharded_polish(
            mesh1, "chr", draft50, bf50, df50.words, cfg)
        dt_sh = time.time() - t8
        same = r_sh.edited == r50.edited and r_sh.subs == r50.subs
        log(f"# 50 Mbp sharded_polish D=1: {dt_sh:.2f}s "
            f"(identical to Polisher: {same})")
        if not same:
            dt_sh = None
    except Exception as exc:
        log(f"# sharded_polish timing skipped: {exc}")

    baseline50 = None
    ref50 = None
    binary = os.path.join(HERE, "native", "ntedit_baseline")
    ref_bin = _ref_bin()
    if os.path.exists(binary) and corpus["fa"] and corpus["bf"]:
        try:
            dt_base = _time_binary([binary, corpus["fa"], corpus["bf"]], 3)
            baseline50 = SCALE / dt_base
            log(f"# 50 Mbp C++ baseline (live, median of 3): "
                f"{baseline50:,.0f} bp/s ({dt_base:.2f}s)")
            if ref_bin:
                with tempfile.TemporaryDirectory() as td:
                    dt_ref = _time_binary(
                        [ref_bin, "-f", corpus["fa"], "-r", corpus["bf"],
                         "-b", os.path.join(td, "ref"), "-t", "4"], 3)
                ref50 = SCALE / dt_ref
                log(f"# 50 Mbp REFERENCE engine (unmodified ntedit.cpp, "
                    f"live, median of 3, -t 4): {ref50:,.0f} bp/s "
                    f"({dt_ref:.2f}s)")
        except Exception as exc:
            log(f"# 50 Mbp baseline measurement skipped: {exc}")
    baseline50 = (
        baseline50
        or measured_cpp_baseline("bases_per_sec_50mbp")
        or measured_cpp_baseline()
        or BASELINE_BASES_PER_SEC
    )
    rec = {
        "metric": "bases_polished_per_sec_chip_50mbp_k25",
        "value": round(SCALE / dt50, 1), "unit": "bases/s",
        "vs_baseline": round(SCALE / dt50 / baseline50, 2),
        "edits": len(r50.subs),
        "wall_ms": round(dt50 * 1e3, 1),
        "gpu": health,
    }
    if dt_sh:
        rec["sharded_d1_wall_ms"] = round(dt_sh * 1e3, 1)
        rec["sharded_d1_vs_polisher"] = round(dt_sh / dt50, 2)
    if dt_cand and dt_seg0:
        rec["repair_cand_ms"] = round(dt_cand * 1e3, 1)
        rec["repair_plain_ms"] = round(dt_seg0 * 1e3, 1)
    if enc_cold is not None:
        rec["draft_upload_cold_ms"] = round(enc_cold * 1e3, 1)
        rec["draft_upload_cached_ms"] = round(enc_warm * 1e3, 1)
    if ref50:
        rec["vs_reference_engine"] = round(SCALE / dt50 / ref50, 2)
    emit(rec)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

def _run_section(flag_arg: str, timeout_s: float, retries: int):
    """Run a bench section in a subprocess (wedge isolation — a killed
    attempt poisons only its own process); returns the section's JSON
    record or None.  Child stderr is relayed; any JSON-looking child
    line is prefixed so the orchestrator's own stdout records stay the
    only parseable JSON lines."""
    for attempt in range(1, retries + 1):
        try:
            child = subprocess.run(
                [sys.executable, os.path.abspath(__file__), flag_arg],
                capture_output=True, text=True, timeout=timeout_s,
            )
            for ln in child.stderr.splitlines():
                if "WARNING" not in ln:
                    log(ln if not ln.lstrip().startswith("{") else "# " + ln)
            out = child.stdout.strip().splitlines()
            if not out:
                log(f"# section {flag_arg} attempt {attempt}: no output "
                    f"(rc={child.returncode})")
                continue
            return json.loads(out[-1])
        except Exception as exc:
            log(f"# section {flag_arg} attempt {attempt} failed: "
                f"{type(exc).__name__}")
    return None


# (section flag, per-attempt timeout, retries, min seconds of remaining
# budget required to start an attempt)
_SECTIONS = [
    ("--ecoli-only", 700.0, 2, 200),
    ("--giant-only", 1500.0, 2, 300),
    ("--snv-only", 800.0, 1, 250),
    ("--human-only", 1800.0, 1, 500),
    ("--scale-only", 700.0, 1, 250),
]


def orchestrate():
    """Default entry.  Every section runs in its own subprocess with a
    hard timeout; the MERGED record is re-emitted on stdout after every
    section, so the capture survives a driver kill at any point.  A
    global deadline (NTEDIT_BENCH_BUDGET seconds, default 2300) bounds
    the whole run: sections that no longer fit are skipped and listed."""
    budget = float(os.environ.get("NTEDIT_BENCH_BUDGET", "2300"))
    t_start = time.time()
    rec = {
        "metric": "bases_polished_per_sec_chip_ecoli_k25",
        "value": 0.0, "unit": "bases/s", "vs_baseline": 0.0,
        "sections_completed": [], "sections_skipped": [],
    }
    for flag_arg, tmo, retries, min_needed in _SECTIONS:
        remaining = budget - (time.time() - t_start)
        if remaining < min_needed:
            log(f"# section {flag_arg} skipped: {remaining:.0f}s left "
                f"< {min_needed}s needed")
            rec["sections_skipped"].append(flag_arg)
            emit(rec)
            continue
        sec = _run_section(flag_arg, min(tmo, max(60.0, remaining)), retries)
        if sec is None:
            rec["sections_skipped"].append(flag_arg)
        else:
            rec["sections_completed"].append(flag_arg)
            _merge_section(rec, flag_arg, sec)
        emit(rec)
    rec["bench_wall_s"] = round(time.time() - t_start, 1)
    emit(rec)


def _merge_section(rec: dict, flag_arg: str, sec: dict) -> None:
    """Fold a section record into the merged headline record.  The
    headline metric/value/vs_baseline becomes the 250 Mbp section's
    (the acceptance regime) once it lands; the ecoli section fills them
    until then."""
    if flag_arg == "--ecoli-only":
        for key in ("identical_to_wavefront", "identical_to_oracle",
                    "three_way_identical",
                    "real_ecoli_identical_to_reference",
                    "real_ecoli_bp_per_sec", "real_ecoli_residual_kinds",
                    "gate_ms", "repair_ms",
                    "snv_1mbp_bp_per_sec", "cbf_1mbp_bp_per_sec"):
            if sec.get(key) is not None:
                rec[key] = sec[key]
        rec["ecoli_bases_per_sec"] = sec.get("value")
        rec["ecoli_vs_baseline"] = sec.get("vs_baseline")
        if rec["metric"] == "bases_polished_per_sec_chip_ecoli_k25":
            rec["value"] = sec.get("value", 0.0)
            rec["vs_baseline"] = sec.get("vs_baseline", 0.0)
        rec["gpu_ecoli"] = sec.get("gpu")
    elif flag_arg == "--giant-only":
        # headline = the acceptance regime (VERDICT r4 next #1)
        rec["metric"] = sec["metric"]
        rec["value"] = sec.get("value", 0.0)
        rec["vs_baseline"] = sec.get("vs_baseline", 0.0)
        if sec.get("vs_reference_engine") is not None:
            rec["vs_reference_engine"] = sec["vs_reference_engine"]
            rec["reference_bp_per_sec_250mbp"] = sec.get("reference_bp_per_sec")
        rec["scale_250mbp_bp_per_sec"] = sec.get("value")
        rec["scale_250mbp_wall_ms"] = sec.get("wall_ms")
        rec["gpu_250mbp"] = sec.get("gpu")
    elif flag_arg == "--snv-only":
        rec["snv_250mbp_bp_per_sec"] = sec.get("value")
        rec["snv_250mbp_records"] = sec.get("records")
        rec["snv_vs_reference_engine_extrapolated"] = sec.get(
            "vs_reference_engine_extrapolated")
        rec["snv_reference_bp_per_sec"] = sec.get("reference_bp_per_sec")
        rec["gpu_snv"] = sec.get("gpu")
    elif flag_arg == "--human-only":
        rec["scale_3gbp_bp_per_sec"] = sec.get("value")
        rec["scale_3gbp_vs_reference_engine_extrapolated"] = sec.get(
            "vs_reference_engine_extrapolated")
        rec["scale_3gbp_peak_rss_gb"] = sec.get("peak_rss_gb")
        rec["gpu_3gbp"] = sec.get("gpu")
    elif flag_arg == "--scale-only":
        rec["scale_50mbp_bp_per_sec"] = sec.get("value")
        rec["scale_50mbp_vs_baseline"] = sec.get("vs_baseline")
        rec["scale_50mbp_vs_reference_engine"] = sec.get("vs_reference_engine")
        rec["sharded_d1_wall_ms"] = sec.get("sharded_d1_wall_ms")
        rec["sharded_d1_vs_polisher"] = sec.get("sharded_d1_vs_polisher")
        rec["gpu_50mbp"] = sec.get("gpu")


if __name__ == "__main__":
    if "--scale-only" in sys.argv:
        scale_main()
    elif "--giant-only" in sys.argv:
        giant_main()
    elif "--snv-only" in sys.argv:
        snv_main()
    elif "--human-only" in sys.argv:
        human_main()
    elif "--ecoli-only" in sys.argv:
        main()
    else:
        orchestrate()
