"""ctypes bindings for the native sparse-repair engine
(native/repair.cpp — the C++ implementation of the oracle spec).

The native engine consumes device-computed gate hints and performs the exact
sequential scan-and-repair of ``Oracle.polish_contig`` at native speed;
its output is reconstructed into the same ``ContigResult`` (contig buffer
with substitutions/masks applied, RopeCells node stream for indels, SubRec
list) so the writers and every downstream consumer are unchanged.
Property-tested for bit-identical equality against the Python oracle in
tests/test_native_repair.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from ntedit_tpu.core import bloom
from ntedit_tpu.engine.config import EngineConfig
from ntedit_tpu.engine.oracle import ContigResult, RopeCells, SubRec

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libntedit_repair.so")

_lib = None
_lib_error: Optional[str] = None


class _NtrFilter(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("hash_num", ctypes.c_int32),
        ("data", ctypes.c_void_p),
        ("nbytes", ctypes.c_uint64),
    ]


class _NtrParams(ctypes.Structure):
    _fields_ = [
        ("k", ctypes.c_int32),
        ("jump", ctypes.c_int32),
        ("mode", ctypes.c_int32),
        ("max_insertions", ctypes.c_int32),
        ("max_deletions", ctypes.c_int32),
        ("min_threshold", ctypes.c_int32),
        ("max_threshold", ctypes.c_int32),
        ("insertion_cap", ctypes.c_int32),
        ("snv", ctypes.c_int32),
        ("mask", ctypes.c_int32),
        ("missing_needed", ctypes.c_double),
        ("present_needed", ctypes.c_double),
        ("present_needed_deletion", ctypes.c_double),
        ("rope_compat", ctypes.c_int32),
    ]


def _build_lib() -> Optional[str]:
    """Build the library from the tracked sources; returns None on
    success, else the build's error text."""
    try:
        res = subprocess.run(
            ["make", "-C", _NATIVE_DIR, "libntedit_repair.so"],
            capture_output=True, text=True, timeout=300,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"make failed to run: {exc}"
    if res.returncode != 0 or not os.path.exists(_LIB_PATH):
        return f"make exited {res.returncode}: {res.stderr.strip()[-2000:]}"
    return None


def get_lib():
    """Load (building on first use) the native repair library, or None."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    src = os.path.join(_NATIVE_DIR, "repair.cpp")
    if not os.path.exists(_LIB_PATH) or (
        os.path.exists(src)
        and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    ):
        err = _build_lib()
        if err is not None:
            # a stale library must not silently stand in for the checked-in
            # source: treat a failed rebuild as unavailable
            _lib_error = err
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as exc:
        _lib_error = str(exc)
        return None
    lib.ntr_polish_contig.restype = ctypes.c_int64
    lib.ntr_polish_contig.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,              # contig, L
        ctypes.c_void_p, ctypes.c_int64,              # gates, n_gates
        ctypes.POINTER(_NtrFilter), ctypes.POINTER(_NtrFilter),
        ctypes.POINTER(_NtrParams),
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ntr_polish_contig_cand.restype = ctypes.c_int64
    lib.ntr_polish_contig_cand.argtypes = (
        lib.ntr_polish_contig.argtypes + [ctypes.c_void_p]  # gate_cand
    )
    lib.ntr_polish_contig_v2.restype = ctypes.c_int64
    lib.ntr_polish_contig_v2.argtypes = (
        lib.ntr_polish_contig.argtypes
        + [ctypes.c_void_p, ctypes.c_void_p]  # gate_cand, site_rows
    )
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded)."""
    get_lib()
    return _lib_error


def _filter_desc(bf) -> Optional[tuple]:
    """Map a host filter object to its C descriptor.

    Returns (struct, backing array) or None for unknown layouts.  The
    backing array is a view of the live filter when it is already
    contiguous (the normal case), else a contiguous snapshot — callers
    must keep it referenced across the native call."""
    if bf is None:
        return None
    host = getattr(bf, "bf", bf)  # unwrap BFLike
    if isinstance(host, bloom.BlockedKmerBloomFilter):
        arr = host.words
        kind = 1
    elif isinstance(host, bloom.KmerCountingBloomFilter8):
        arr = host.counters
        kind = 2
    elif isinstance(host, bloom.KmerBloomFilter):
        arr = host.data
        kind = 0
    else:
        return None
    if not arr.flags["C_CONTIGUOUS"]:
        # non-contiguous views would hand the engine a wrong layout; the
        # copy is a descriptor-time SNAPSHOT of the filter, which is fine
        # (filters are read-only during repair)
        arr = np.ascontiguousarray(arr)
    return _NtrFilter(
        kind=kind, hash_num=host.hash_num,
        data=arr.ctypes.data_as(ctypes.c_void_p).value,
        nbytes=arr.nbytes,
    ), arr  # keep arr alive


def _params_of(cfg: EngineConfig) -> _NtrParams:
    return _NtrParams(
        k=cfg.k, jump=cfg.jump, mode=cfg.mode,
        max_insertions=cfg.max_insertions, max_deletions=cfg.max_deletions,
        min_threshold=cfg.min_threshold, max_threshold=cfg.max_threshold,
        insertion_cap=cfg.insertion_cap,
        snv=int(cfg.snv), mask=int(cfg.mask),
        missing_needed=float(cfg.missing_needed),
        present_needed=float(cfg.present_needed),
        present_needed_deletion=float(cfg.present_needed_deletion),
        rope_compat=int(cfg.rope_compat),
    )


def _run_raw(lib, contig: np.ndarray, pristine: bytes, gates, bf_struct,
             rep_struct, params, initial_caps=None, gate_cand=None,
             site_rows=None):
    """One ntr_polish_contig call with capacity retries.

    ``contig`` is modified in place (it may be a view into a shared
    whole-contig buffer); every retry restores it from ``pristine`` first —
    the engine applies substitutions/masks before a capacity retcode can
    surface.  Returns (subs [N,10] int64, nodes [M,4] int64) or None.
    ctypes releases the GIL for the call, so segment runs parallelize."""
    L = contig.size
    if gates is not None:
        gates = np.ascontiguousarray(gates, dtype=np.int64)
        gates_ptr = gates.ctypes.data_as(ctypes.c_void_p).value
        n_gates = gates.size
    else:
        gates_ptr, n_gates = None, 0
    cand_ptr = None
    if gate_cand is not None and gates is not None and len(gate_cand) == n_gates:
        gate_cand = np.ascontiguousarray(gate_cand, dtype=np.uint8)
        cand_ptr = gate_cand.ctypes.data_as(ctypes.c_void_p).value
    rows_ptr = None
    if site_rows is not None and gates is not None and len(site_rows) == n_gates:
        site_rows = np.ascontiguousarray(site_rows, dtype=np.uint8)
        rows_ptr = site_rows.ctypes.data_as(ctypes.c_void_p).value
    subs_cap = max(4096, L // 64)
    nodes_cap = max(4096, L // 64)
    if initial_caps is not None:  # capacity-retry test hook
        subs_cap, nodes_cap = initial_caps
    first = True
    while True:
        if not first:
            contig[:] = np.frombuffer(pristine, dtype=np.uint8)
        first = False
        subs_buf = np.empty(subs_cap * 10, dtype=np.int64)
        nodes_buf = np.empty(nodes_cap * 4, dtype=np.int64)
        n_subs = ctypes.c_int64(0)
        n_nodes = ctypes.c_int64(0)
        args = [
            contig.ctypes.data_as(ctypes.c_void_p).value, L,
            gates_ptr, n_gates,
            ctypes.byref(bf_struct),
            ctypes.byref(rep_struct) if rep_struct is not None else None,
            ctypes.byref(params),
            subs_buf.ctypes.data_as(ctypes.c_void_p).value, subs_cap,
            ctypes.byref(n_subs),
            nodes_buf.ctypes.data_as(ctypes.c_void_p).value, nodes_cap,
            ctypes.byref(n_nodes),
        ]
        if rows_ptr is not None:
            rc = lib.ntr_polish_contig_v2(*args, cand_ptr, rows_ptr)
        elif cand_ptr is not None:
            rc = lib.ntr_polish_contig_cand(*args, cand_ptr)
        else:
            rc = lib.ntr_polish_contig(*args)
        if rc == -2:
            subs_cap *= 4
            continue
        if rc == -3:
            nodes_cap *= 4
            continue
        if rc != 0:
            return None
        return (
            subs_buf[: n_subs.value * 10].reshape(-1, 10),
            nodes_buf[: n_nodes.value * 4].reshape(-1, 4),
        )


def _subs_of(sb: np.ndarray, offset: int = 0) -> list:
    return [
        SubRec(
            pos=int(r[0]) + offset, draft_char=int(r[1]), sub_base=int(r[2]),
            num_support=int(r[3]),
            altbase1=int(r[4]), altsupp1=int(r[5]),
            altbase2=int(r[6]), altsupp2=int(r[7]),
            altbase3=int(r[8]), altsupp3=int(r[9]),
        )
        for r in sb
    ]


def _append_nodes(nodes: list, nb: np.ndarray, offset: int = 0) -> int:
    """Raw [M,4] node rows -> RopeCells node list entries (span coords
    shifted by ``offset``).  Returns the cell count appended."""
    total = 0
    for kind, a, b, sup in nb:
        if kind == 0:
            nodes.append(["span", int(a) + offset, int(b) + offset, int(sup)])
            total += int(b) - int(a) + 1
        else:
            # ins cell [-1, char, ins_sup, span_sup]
            nodes.append(["ins", [-1, int(a), int(sup), int(b)]])
            total += 1
    return total


def _filters_of(host_bloom, host_bloomrep):
    bfd = _filter_desc(host_bloom)
    if bfd is None:
        return None
    bf_struct, bf_keep = bfd
    rep_struct = rep_keep = None
    if host_bloomrep is not None:
        repd = _filter_desc(host_bloomrep)
        if repd is None:
            return None
        rep_struct, rep_keep = repd
    return bf_struct, rep_struct, (bf_keep, rep_keep)


def polish_contig_native(
    host_bloom,
    host_bloomrep,
    cfg: EngineConfig,
    header: str,
    seq: bytes | np.ndarray,
    gate_hint: Optional[np.ndarray] = None,
    initial_caps: Optional[tuple] = None,
    gate_cand: Optional[np.ndarray] = None,
    site_rows: Optional[np.ndarray] = None,
) -> Optional[ContigResult]:
    """Run the native engine on one contig.  Returns None when the native
    library or the filter layout is unavailable (caller falls back)."""
    lib = get_lib()
    if lib is None:
        return None
    fd = _filters_of(host_bloom, host_bloomrep)
    if fd is None:
        return None
    bf_struct, rep_struct, _keep = fd
    params = _params_of(cfg.validate())
    seq_bytes = bytes(seq)
    contig = np.frombuffer(seq_bytes, dtype=np.uint8).copy()
    out = _run_raw(lib, contig, seq_bytes, gate_hint, bf_struct, rep_struct,
                   params, initial_caps, gate_cand=gate_cand,
                   site_rows=site_rows)
    if out is None:
        return None
    sb, nb = out
    cells = RopeCells(0)
    cells.nodes = []
    cells._len = _append_nodes(cells.nodes, nb)
    cells._cum = None
    return ContigResult(header, bytearray(contig.tobytes()), cells,
                        _subs_of(sb))


# ---------------------------------------------------------------------------
# Segmented parallel repair: gate runs far enough apart are independent
# (the reference's only engine parallelism is contigs, ntedit.cpp:2213-2250;
# segment parallelism is the single-contig analogue and is exact — see the
# overflow guard below).
# ---------------------------------------------------------------------------


def _gap_margin(cfg) -> tuple:
    """(gap, margin): a gap of > ``gap`` gate-free heads between
    consecutive gates means the dense pass proved the region clean against
    ORIGINAL content; an edit's influence (content change + re-gate reach
    + trial lookahead) cannot cross it, so the scan state on the far side
    is exactly the fresh-seed state.  ``margin`` is the per-segment
    activity bound checked by the overflow guard."""
    gap = 4 * cfg.k + cfg.insertion_cap + cfg.max_deletions + 32
    margin = gap - 2 * cfg.k - cfg.max_deletions - 2
    return gap, margin


def _bucket_bounds(gates: np.ndarray, L: int, cfg, n_buckets: int) -> tuple:
    """Group gates into <= n_buckets contiguous buckets cut only at quiet
    gaps (> gap gate-free heads), balanced by gate count.  One native call
    per bucket: within a bucket the engine fast-forwards across internal
    gaps exactly like the whole-contig run, so only bucket BOUNDARIES need
    the independence argument (and the trailing overflow guard).

    Returns (idx_bounds, margin): idx_bounds is a list of (i0, i1) gate
    index ranges."""
    gap, margin = _gap_margin(cfg)
    n = len(gates)
    cuts = np.nonzero(np.diff(gates) > gap)[0] + 1  # legal cut indices
    if n_buckets <= 1 or not len(cuts):
        return [(0, n)], margin
    targets = n * np.arange(1, n_buckets) / n_buckets
    chosen = sorted({int(cuts[np.abs(cuts - t).argmin()]) for t in targets})
    edges = [0] + chosen + [n]
    return [
        (edges[i], edges[i + 1])
        for i in range(len(edges) - 1)
        if edges[i + 1] > edges[i]
    ], margin


def polish_contig_segmented(
    host_bloom,
    host_bloomrep,
    cfg: EngineConfig,
    header: str,
    seq: bytes | np.ndarray,
    gates: np.ndarray,
    threads: int = 4,
    allow_snv: bool = False,
    gate_cand: Optional[np.ndarray] = None,
    site_rows: Optional[np.ndarray] = None,
) -> Optional[ContigResult]:
    """Parallel exact repair: independent gate-run segments in threads.

    Output is identical to the sequential native scan: segments are cut
    only across gate-free gaps wider than any edit's influence, each
    segment's repair is the sequential engine on its slice, and an
    overflow guard falls back to the whole-contig sequential run if a
    segment's activity ever reaches its right margin (pathological edit
    cascades).  Returns None when the native library is unavailable.

    ``allow_snv``: SNV mode gates every head, so hint-based segmentation
    is only sound when the hints are the device-derived CANDIDATE set
    (flag.snv_candidate_positions — positions between candidates are
    provably no-ops); the Polisher sets this after checking eligibility."""
    lib = get_lib()
    if lib is None:
        return None
    if cfg.snv and not allow_snv:
        return None  # raw SNV gates every head: no quiet gaps to cut at
    fd = _filters_of(host_bloom, host_bloomrep)
    if fd is None:
        return None
    bf_struct, rep_struct, _keep = fd
    cfg = cfg.validate()
    params = _params_of(cfg)
    seq_bytes = bytes(seq)
    L = len(seq_bytes)
    gates = np.ascontiguousarray(gates, dtype=np.int64)
    if gate_cand is not None and len(gate_cand) != len(gates):
        gate_cand = None
    if site_rows is not None and len(site_rows) != len(gates):
        site_rows = None
    if len(gates) == 0:
        cells = RopeCells(L)
        return ContigResult(header, bytearray(seq_bytes), cells, [])

    gap, _ = _gap_margin(cfg)
    contig = np.frombuffer(seq_bytes, dtype=np.uint8).copy()
    idx_bounds, margin = _bucket_bounds(gates, L, cfg, n_buckets=4 * threads)
    if len(idx_bounds) == 1 or threads <= 1:
        out = _run_raw(lib, contig, seq_bytes, gates, bf_struct, rep_struct,
                       params, gate_cand=gate_cand, site_rows=site_rows)
        if out is None:
            return None
        sb, nb = out
        cells = RopeCells(0)
        cells.nodes = []
        cells._len = _append_nodes(cells.nodes, nb)
        cells._cum = None
        return ContigResult(header, bytearray(contig.tobytes()), cells,
                            _subs_of(sb))

    from concurrent.futures import ThreadPoolExecutor

    runner = _seg_runner(lib, contig, seq_bytes, bf_struct, rep_struct,
                         params, margin)
    jobs = []
    for i0, i1 in idx_bounds:
        lo = int(gates[i0])
        hi = int(min(L, gates[i1 - 1] + gap))
        seg_cand = gate_cand[i0:i1] if gate_cand is not None else None
        seg_rows = site_rows[i0:i1] if site_rows is not None else None
        jobs.append((lo, hi, gates[i0:i1], seg_cand, seg_rows))
    with ThreadPoolExecutor(max_workers=min(threads, len(jobs))) as ex:
        results = list(ex.map(lambda j: runner(*j), jobs))
    return _finish_segments(
        lib, header, seq_bytes, contig, gates, bf_struct, rep_struct, params,
        [(j[0], j[1]) for j in jobs], results,
    )


def _seg_runner(lib, contig, seq_bytes, bf_struct, rep_struct, params, margin):
    """Closure running one segment: (lo, hi, abs_gates) -> (sb, nb) raw
    arrays, "overflow" when activity reaches the right margin, or None on
    engine failure."""

    def run(lo: int, hi: int, seg_gates_abs: np.ndarray, seg_cand=None,
            seg_rows=None):
        view = contig[lo:hi]
        pristine = seq_bytes[lo:hi]
        out = _run_raw(lib, view, pristine, seg_gates_abs - lo, bf_struct,
                       rep_struct, params, gate_cand=seg_cand,
                       site_rows=seg_rows)
        if out is None:
            return None
        sb, nb = out
        # overflow guard: activity must stay left of the margin
        limit = int(seg_gates_abs[-1]) - lo + margin
        if len(sb) and int(sb[:, 0].max()) > limit:
            return "overflow"
        if len(nb):
            last = nb[-1]
            if not (last[0] == 0 and int(last[2]) == hi - lo - 1
                    and int(last[1]) <= limit):
                return "overflow"
        return sb, nb

    return run


def _finish_segments(lib, header, seq_bytes, contig, all_gates, bf_struct,
                     rep_struct, params, bounds, results):
    """Handle overflow/failure fallbacks, then stitch segment results."""
    L = len(seq_bytes)
    if any(r is None for r in results):
        return None
    if any(isinstance(r, str) for r in results):
        # pathological cascade: exact fallback to the sequential whole run
        contig = np.frombuffer(seq_bytes, dtype=np.uint8).copy()
        out = _run_raw(lib, contig, seq_bytes, all_gates, bf_struct,
                       rep_struct, params)
        if out is None:
            return None
        sb, nb = out
        cells = RopeCells(0)
        cells.nodes = []
        cells._len = _append_nodes(cells.nodes, nb)
        cells._cum = None
        return ContigResult(header, bytearray(contig.tobytes()), cells,
                            _subs_of(sb))

    # stitch: inter-segment clean spans + per-segment node streams (writers
    # merge coordinate-contiguous spans, so seam splits are render-equal)
    subs = []
    nodes = []
    total = 0
    cursor = 0
    for (lo, hi), (sb, nb) in zip(bounds, results):
        if lo > cursor:
            nodes.append(["span", cursor, lo - 1, 0])
            total += lo - cursor
        subs.extend(_subs_of(sb, offset=lo))
        total += _append_nodes(nodes, nb, offset=lo)
        cursor = hi
    if cursor < L:
        nodes.append(["span", cursor, L - 1, 0])
        total += L - cursor
    cells = RopeCells(0)
    cells.nodes = nodes
    cells._len = total
    cells._cum = None
    return ContigResult(header, bytearray(contig.tobytes()), cells, subs)


def polish_contig_pipelined(
    host_bloom,
    host_bloomrep,
    cfg: EngineConfig,
    header: str,
    seq: bytes | np.ndarray,
    gate_chunks,
    threads: int = 4,
    collect_gates: Optional[list] = None,
) -> Optional[ContigResult]:
    """Segmented repair overlapped with the streaming dense pass.

    ``gate_chunks`` yields (frontier, abs_gates) — or (frontier,
    abs_gates, site_rows) with uint8 [len(gates), 6] device-precomputed
    decision rows parallel to the gates (flag.iter_polish_site_chunks) —
    with every head < frontier final.  Segments whose closing quiet gap
    is confirmed are submitted to the repair pool immediately, so the
    host repairs chunk i while the device still computes chunk i+1's
    gates.  Output is identical to the sequential scan (same
    segment/overflow machinery as polish_contig_segmented).

    ``collect_gates``: optional list the consumed gate arrays are appended
    to, so a caller can reuse the dense pass as a hint if this engine
    returns None after the stream was (partially) drained."""
    lib = get_lib()
    if lib is None or cfg.snv:
        return None
    fd = _filters_of(host_bloom, host_bloomrep)
    if fd is None:
        return None
    bf_struct, rep_struct, _keep = fd
    cfg = cfg.validate()
    params = _params_of(cfg)
    seq_bytes = bytes(seq)
    L = len(seq_bytes)
    gap, margin = _gap_margin(cfg)
    contig = np.frombuffer(seq_bytes, dtype=np.uint8).copy()
    runner = _seg_runner(lib, contig, seq_bytes, bf_struct, rep_struct,
                         params, margin)

    from concurrent.futures import ThreadPoolExecutor

    # closed segments accumulate into a bucket; one native call per bucket
    # (few large calls, not thousands of tiny ones) sized so ~2 buckets per
    # thread stay in flight against typical gate densities
    bucket_budget = 16384
    gbuf = np.empty(0, dtype=np.int64)  # gates not yet assigned to a segment
    rbuf = None                         # parallel site-row buffer (or None)
    bucket = []                         # closed gate groups awaiting submit
    bucket_rows = []
    bucket_n = 0
    chunks = []                         # all gate arrays (fallback replay)
    bounds = []
    futures = []
    with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:

        def submit_bucket():
            nonlocal bucket, bucket_rows, bucket_n
            if not bucket:
                return
            bgates = np.concatenate(bucket)
            if any(r is not None for r in bucket_rows):
                brows = np.concatenate([
                    r if r is not None else np.zeros((len(gr), 6), np.uint8)
                    for gr, r in zip(bucket, bucket_rows)
                ])
            else:
                brows = None
            lo = int(bgates[0])
            hi = int(min(L, bgates[-1] + gap))
            bounds.append((lo, hi))
            futures.append(ex.submit(runner, lo, hi, bgates, None, brows))
            bucket = []
            bucket_rows = []
            bucket_n = 0

        for item in gate_chunks:
            frontier, g = item[0], item[1]
            rows = item[2] if len(item) > 2 else None
            chunks.append(np.asarray(g, dtype=np.int64))
            if collect_gates is not None:
                collect_gates.append(chunks[-1])
            prev_n = len(gbuf)
            gbuf = np.concatenate([gbuf, chunks[-1]])
            if rows is not None or rbuf is not None:
                if rbuf is None:
                    rbuf = np.zeros((prev_n, 6), dtype=np.uint8)
                if rows is None:
                    rows = np.zeros((len(g), 6), dtype=np.uint8)
                rbuf = np.concatenate([rbuf, rows])
            if not len(gbuf):
                continue
            # close every group whose trailing quiet gap is confirmed:
            # the group's last gate is > gap before the frontier AND > gap
            # before the next group's first gate
            splits = np.nonzero(np.diff(gbuf) > gap)[0] + 1
            groups = np.split(gbuf, splits)
            rgroups = (np.split(rbuf, splits) if rbuf is not None
                       else [None] * len(groups))
            closed = list(groups[:-1])
            closed_r = list(rgroups[:-1])
            last = groups[-1]
            if len(last) and int(last[-1]) + gap < frontier:
                closed.append(last)
                closed_r.append(rgroups[-1])
                gbuf = np.empty(0, dtype=np.int64)
                if rbuf is not None:
                    rbuf = np.zeros((0, 6), dtype=np.uint8)
            else:
                gbuf = last
                if rbuf is not None:
                    rbuf = rgroups[-1]
            for grp, rgrp in zip(closed, closed_r):
                bucket.append(grp)
                bucket_rows.append(rgrp)
                bucket_n += len(grp)
                if bucket_n >= bucket_budget:
                    submit_bucket()
        if len(gbuf):
            bucket.append(gbuf)
            bucket_rows.append(rbuf)
        submit_bucket()
        results = [f.result() for f in futures]

    all_gates = (
        np.concatenate(chunks) if chunks else np.empty(0, dtype=np.int64)
    )
    if not len(all_gates):
        cells = RopeCells(L)
        return ContigResult(header, bytearray(seq_bytes), cells, [])
    return _finish_segments(
        lib, header, seq_bytes, contig, all_gates, bf_struct, rep_struct,
        params, bounds, results,
    )
