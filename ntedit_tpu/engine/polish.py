"""Polish pipeline: device dense flag pass + exact sparse repair.

The throughput-dominant work — one canonical multi-hash + Bloom probe per
draft base (SURVEY.md §3.3) — runs on device as a batched dense pass
(ntedit_tpu.engine.flag).  The sparse, branchy repair of
flagged sites runs on host with gate-hint fast-forwarding — the scan jumps
over stretches the device proved clean and behaves exactly like the full
sequential scan elsewhere — through one of three interchangeable engines,
all property-tested bit-identical to the scalar spec
(ntedit_tpu.engine.oracle):

* ``pipelined`` — the production path: the streaming dense pass
  (flag.iter_gate_chunks) overlapped with the threaded C++ segment repair
  (native_repair.polish_contig_pipelined); the device computes chunk i+1's
  gates while -t host threads repair chunk i's segments.
* ``native``  — the C++ sparse-repair engine on the complete gate hint
  (native/repair.cpp via ntedit_tpu.engine.native_repair), threaded over
  independent segments (tests/test_native_repair.py).
* ``wavefront`` — batched numpy rounds (ntedit_tpu.engine.wavefront); used
  on the CPU backend when the native library is unavailable
  (tests/test_wavefront.py).  On a GPU a failed native build is an error.
* ``sequential`` — the oracle itself with gate hints; the always-correct
  fallback (tests/test_polish_pipeline.py).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import jax
import numpy as np

from ntedit_tpu.core import bloom
from ntedit_tpu.engine import flag
from ntedit_tpu.engine.config import EngineConfig
from ntedit_tpu.engine.oracle import BFLike, ContigResult, Oracle


class Polisher:
    """Reusable polisher: load filters once, polish many contigs."""

    def __init__(
        self,
        host_bloom,
        host_bloomrep=None,
        cfg: Optional[EngineConfig] = None,
        use_device: bool = True,
        chunk: int = flag.DEFAULT_CHUNK,
        fast_sites: bool = True,
        engine: str = "auto",
        df: "bloom.DeviceFilter | None" = None,
    ):
        if cfg is None:
            cfg = EngineConfig(k=host_bloom.k, hash_num=host_bloom.hash_num)
        if cfg.k == 0:
            import dataclasses

            cfg = dataclasses.replace(cfg, k=host_bloom.k, hash_num=host_bloom.hash_num)
        self.cfg = cfg.validate()
        self.bloom = host_bloom
        self.bloomrep = host_bloomrep
        self.oracle = Oracle(host_bloom, host_bloomrep, self.cfg, fast=fast_sites)
        self.use_device = use_device
        self.chunk = chunk
        if engine == "auto":
            from ntedit_tpu.engine import native_repair

            if native_repair.available():
                engine = "pipelined"
            elif use_device and jax.default_backend() != "cpu":
                # a device run must not quietly repair with the numpy engine
                raise RuntimeError(
                    "native repair library unavailable: "
                    f"{native_repair.build_error()}"
                )
            else:
                engine = "wavefront"
        self.engine = engine if use_device else "sequential"
        # a caller that just built the filter ON device passes its df to
        # skip the host->device re-upload of the filter
        if df is not None:
            self.df = df
        else:
            self.df = bloom.DeviceFilter.from_host(host_bloom) if use_device else None
        # the wavefront/sequential fallbacks mutate the shared Oracle;
        # the overlapped polish() stream runs polish_contig concurrently,
        # so those paths serialize on this lock
        import threading

        self._oracle_lock = threading.Lock()

    def _snv_fast_eligible(self) -> bool:
        """The SNV candidate hint is exact only when the alternate
        pre-check (contains && solid) is computable on device and gating
        decisions cannot arise elsewhere: non-counting filter, no reject
        BF, mode != 2 (mode 2 bypasses the pre-check), mask off (masking
        touches every no-fix position)."""
        return (
            self.use_device
            and self.df is not None
            and not self.df.counting
            and self.bloomrep is None
            and self.cfg.mode != 2
            and not self.cfg.mask
        )

    def _polish_cand_eligible(self) -> bool:
        """Device substitution-candidate masks are an exact stand-in for
        the engine's first-level contains(changelast) probe only when
        that probe is the whole gate: non-counting filter, no reject BF
        (solid() degenerates to true), mode != 2 (mode 2 bypasses the
        probe).  Mask mode is fine — in-place lowercase writes are
        tracked by the engine's pristine-window check.  Opt-in via
        NTEDIT_TPU_CAND=1 (costs a second dense device pass)."""
        import os

        return (
            os.environ.get("NTEDIT_TPU_CAND") == "1"
            and self.use_device
            and self.df is not None
            and not self.df.counting
            and self.bloomrep is None
            and self.cfg.mode != 2
        )

    def gate_positions(self, seq: np.ndarray) -> Optional[np.ndarray]:
        """One-shot dense gate pass (the streaming variant is
        flag.iter_gate_chunks, used by the pipelined engine)."""
        if not self.use_device:
            return None
        return flag.flag_contig_gates(
            seq, self.df, snv=self.cfg.snv,
            min_threshold=self.cfg.min_threshold, chunk=self.chunk,
        )

    def polish_contig(self, header: str, seq: np.ndarray) -> ContigResult:
        if self.cfg.verbose:
            # -v per-trial tracing lives in the sequential spec engine
            # (matching ntedit.cpp:1524-1530,1650-1657,1982-1990); tracing
            # is a debugging mode, so the scalar path is the right one
            return self.oracle.polish_contig(
                header, bytes(seq), gate_hint=self.gate_positions(seq)
            )
        hint = None
        if self.engine == "pipelined" and not self.cfg.snv:
            # production path: streaming dense pass overlapped with the
            # threaded segment repair (no upfront full gate pass).  With
            # NTEDIT_TPU_SITE_ROWS=1 the stream also carries device-
            # precomputed per-site decision rows (cluster-start heads:
            # confirmation check_missing + alternate pre bits + verify
            # counts — flag.iter_polish_site_chunks) that the engine
            # consumes at pristine windows instead of probing; sites
            # whose decision would enter the indel trials fall back to
            # live probes inside the engine, so output is bit-identical.
            # OPT-IN: the rows cost extra device work and readback on
            # the dense side and save part of the repair; whether that
            # pays on the GPU has not been measured.
            from ntedit_tpu.engine import native_repair

            import os

            streamed = []
            rows_ok = (
                self.df is not None and not self.df.counting
                and self.bloomrep is None and self.cfg.mode != 2
                and os.environ.get("NTEDIT_TPU_SITE_ROWS") == "1"
            )
            stream = (
                flag.iter_polish_site_chunks(
                    seq, self.df, self.cfg.jump, chunk=self.chunk)
                if rows_ok else
                flag.iter_gate_chunks(
                    seq, self.df, snv=False,
                    min_threshold=self.cfg.min_threshold, chunk=self.chunk,
                )
            )
            res = native_repair.polish_contig_pipelined(
                self.oracle.bloom, self.oracle.bloomrep, self.cfg,
                header, seq, stream,
                threads=self.cfg.threads,
                collect_gates=streamed,
            )
            if res is not None:
                return res
            if streamed:
                # the dense pass already ran to completion; reuse it as the
                # hint instead of paying a second device scan
                hint = np.concatenate(streamed)
        if (
            self.engine in ("native", "pipelined")
            and self.cfg.snv
            and self._snv_fast_eligible()
        ):
            # SNV fast path: positions where no alternate's k-mer is even
            # present are provably no-ops (no record, no edit), so the
            # device-computed candidate set is an exact hint.  With
            # NTEDIT_TPU_SITE_ROWS=1 the pass also precomputes each
            # candidate's full decision inputs (confirmation check_there,
            # alternate pre-check bits, verify counts — flag.snv_site_data)
            # consumed verbatim by the engine at pristine sites.  OPT-IN:
            # the extra sparse compute and readback trade against the
            # live repair they save; not yet measured on the GPU.
            import os

            from ntedit_tpu.engine import native_repair

            if os.environ.get("NTEDIT_TPU_SITE_ROWS") == "1":
                cand, rows = flag.snv_site_data(
                    seq, self.df, self.cfg.jump, chunk=self.chunk)
            else:
                cand = flag.snv_candidate_positions(
                    seq, self.df, chunk=self.chunk)
                rows = None
            res = None
            if self.cfg.threads > 1:
                res = native_repair.polish_contig_segmented(
                    self.oracle.bloom, None, self.cfg, header, seq, cand,
                    threads=self.cfg.threads, allow_snv=True,
                    site_rows=rows,
                )
            if res is None:
                res = native_repair.polish_contig_native(
                    self.oracle.bloom, None, self.cfg, header, seq,
                    gate_hint=cand, site_rows=rows,
                )
            if res is not None:
                return res
        if hint is None:
            hint = self.gate_positions(seq)
        cand_masks = None
        if (
            hint is not None and len(hint)
            and not self.cfg.snv
            and self._polish_cand_eligible()
        ):
            # device pre-verification of substitution candidates
            # (repair.cpp fix_site consult): one extra
            # dense changelast pass, ~1 byte per gate read back.  Opt-in
            # (NTEDIT_TPU_CAND=1): it pays only where host repair, not
            # the dense pass, is the wall
            cand_masks = flag.polish_candidate_masks(
                seq, self.df, hint, chunk=self.chunk
            )
        if self.engine in ("native", "pipelined"):
            from ntedit_tpu.engine import native_repair

            res = None
            if hint is not None and not self.cfg.snv and self.cfg.threads > 1:
                res = native_repair.polish_contig_segmented(
                    self.oracle.bloom, self.oracle.bloomrep, self.cfg,
                    header, seq, hint, threads=self.cfg.threads,
                    gate_cand=cand_masks,
                )
            if res is None:
                res = native_repair.polish_contig_native(
                    self.oracle.bloom, self.oracle.bloomrep, self.cfg,
                    header, seq, gate_hint=hint, gate_cand=cand_masks,
                )
            if res is not None:
                return res
            # library/filter-layout unavailable: wavefront path
        if self.engine in ("wavefront", "native", "pipelined") and hint is not None:
            from ntedit_tpu.engine import wavefront

            if self.cfg.snv:
                if self._snv_fast_eligible():
                    # positions with no passing alternate are provably
                    # no-ops (same exactness argument as the native SNV
                    # fast path, tests/test_native_repair.py): the
                    # candidate set is an exact hint — the fallback no
                    # longer degenerates to O(L) site evaluations
                    hint_wf = flag.snv_candidate_positions(
                        seq, self.df, chunk=self.chunk)
                else:
                    # SNV gates every head; the dense hint only
                    # constrains candidates in polish mode
                    hint_wf = np.arange(max(0, len(seq) - self.cfg.k + 1))
            else:
                hint_wf = hint
            try:
                with self._oracle_lock:
                    return wavefront.polish_contig_wavefront(
                        self.oracle, header, bytes(seq), hint_wf
                    )
            except wavefront.WavefrontBailout:
                pass  # rare scan-order-dependent case: sequential engine
        with self._oracle_lock:
            return self.oracle.polish_contig(header, bytes(seq), gate_hint=hint)

    def polish(
        self, contigs: Iterable[Tuple[str, np.ndarray]]
    ) -> Iterator[ContigResult]:
        """Polish a stream of (header, seq) contigs.  Contigs shorter than
        min_contig_len are read but produce no output (reference behaviour,
        ntedit.cpp:2242-2245).

        With the native engine and -t > 1, contigs overlap two deep (the
        next contig's dense pass dispatches while the current one repairs)
        — the reference's per-contig OpenMP parallelism
        (ntedit.cpp:2213-2250) without its completion-order
        nondeterminism: results are yielded strictly in input order
        (FIDELITY #6)."""
        overlap = (
            self.engine in ("native", "pipelined")
            and self.cfg.threads > 1
            and not self.cfg.verbose
        )
        if overlap:
            from ntedit_tpu.engine import native_repair

            overlap = native_repair.available()  # fallbacks mutate oracle
        if not overlap:
            for header, seq in contigs:
                if len(seq) >= self.cfg.min_contig_len:
                    yield self.polish_contig(header, seq)
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=2) as ex:
            pending = deque()
            for header, seq in contigs:
                if len(seq) < self.cfg.min_contig_len:
                    continue
                pending.append(ex.submit(self.polish_contig, header, seq))
                while len(pending) > 2:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
