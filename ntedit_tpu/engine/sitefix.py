"""Vectorized flagged-site repair, batched across sites.

Re-expresses everything the scalar oracle's ``_fix_site`` does sequentially
— the subset-missing confirmation, substitution verify scans, insertion and
deletion trials — as window hashes over patched slices, probed in bulk and
batched over MANY sites at once.  Every reference "roll loop" becomes
"hashes of consecutive windows of a patched sequence", which the rolling
recurrences guarantee equal (tests/test_nthash.py::test_roll_matches_scratch).
This is the blueprint (and host reference) of the on-device repair machine;
the probe backend is swappable (numpy here, jnp gathers on device).

Batched evaluation applies only at *pristine* sites — the k-window plus the
trial lookahead lies in untouched contiguous original cells away from the
contig ends.  Everything else falls back to the scalar spec path.

Median collections inside trials are deliberately skipped: the reference
computes them but uses them only for verbose output (their threshold code
is commented out, ntedit.cpp:2000-2007, 1536-1541, 1664-1670); only the
confirmation scan's check_there median is live (gate + SNV baseline).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ntedit_tpu.core import nthash_ref as nh
from ntedit_tpu.engine.config import ACCEPTED, MULTI_POSSIBLE_BASES, NUM_TRIES
from ntedit_tpu.engine.oracle import (
    ORIG,
    is_atgc,
    median_u8,
    shuffle_best,
)

_ACC = np.zeros(256, dtype=bool)
for _c in ACCEPTED:
    _ACC[_c] = True
    _ACC[_c + 32] = True


def span_for(cfg) -> int:
    # 2k window+lookahead, indel slack, +2 guard; the max_insertions term
    # lets the wavefront precompute post-insertion zone re-flags from W
    return 2 * cfg.k + cfg.max_deletions + cfg.max_insertions + 2


def _bulk(oracle, mat: np.ndarray):
    """Hash every window of every row and probe in bulk.

    mat [R, L] -> (contains, solid, counts) arrays [R, L-k+1]."""
    cfg = oracle.cfg
    k = cfg.k
    fh, rh = nh.batch_window_hashes(mat, k)
    base = nh.canonical(fh, rh)
    shape = base.shape
    bl = oracle.bloom
    if getattr(bl.bf, "blocked_layout", False) and oracle.bloomrep is None:
        # blocked filters probe on the canonical hash alone — skip the
        # multi-hash mixing entirely
        contains = bl.bf.contains_base(base.reshape(-1)).reshape(shape)
        return contains, np.ones(shape, dtype=bool), contains.astype(np.uint8)
    flat = nh.extend_hashes_vec(base.reshape(-1), k, cfg.hash_num)
    if bl.is_counting:
        counts = bl.bf.count_hashes(flat).reshape(shape)
        contains = counts > 0
        cnt_ok = (counts >= cfg.min_threshold) & (counts <= cfg.max_threshold)
    else:
        contains = bl.bf.contains_hashes(flat).reshape(shape)
        counts = contains.astype(np.uint8)
        cnt_ok = np.ones(shape, dtype=bool)
    if oracle.bloomrep is not None:
        rep = oracle.bloomrep.bf
        if oracle.bloomrep.is_counting:
            rep_in = rep.count_hashes(flat).reshape(shape) > 0
        else:
            rep_in = rep.contains_hashes(flat).reshape(shape)
    else:
        rep_in = np.zeros(shape, dtype=bool)
    solid = (~rep_in) & cnt_ok
    return contains, solid, counts


# ---------------------------------------------------------------------------
# Batched stages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ConfirmResult:
    check_missing: np.ndarray   # [S]
    check_there: np.ndarray     # [S]
    there_median: np.ndarray    # [S]
    do_not_fix: np.ndarray      # [S] bool
    gate: np.ndarray            # [S] bool: live absence gate of the window itself


def confirm_batch(oracle, W: np.ndarray, draft_chars: np.ndarray) -> ConfirmResult:
    """Subset-missing confirmation (ntedit.cpp:1820-1873) for S pristine
    sites.  W [S, >=2k]: slice starting at each site's window head."""
    cfg = oracle.cfg
    k = cfg.k
    S = W.shape[0]
    contains, _solid, counts = _bulk(oracle, W[:, : 2 * k])
    tail_acc = _ACC[W[:, k : 2 * k]]                       # [S, k]
    bad_any = ~tail_acc
    first_bad = np.where(bad_any.any(1), bad_any.argmax(1), k)  # limit per row
    kk = np.arange(k)
    active = kk[None, :] < first_bad[:, None]
    stride = (kk % cfg.jump) == 0
    win = contains[:, 1 : k + 1]
    miss = active & stride[None, :] & ~win
    atgc = np.array([is_atgc(int(c)) for c in draft_chars], dtype=bool)
    cnt_ok = (
        counts[:, 1 : k + 1] >= cfg.min_threshold
        if oracle.bloom.is_counting
        else np.ones_like(win)
    )
    there = active & stride[None, :] & win & atgc[:, None] & cnt_ok
    med = np.zeros(S, dtype=np.int64)
    if oracle.bloom.is_counting:
        for s in range(S):
            med[s] = median_u8(list(counts[s, 1 : k + 1][there[s]]))
    gate = np.full(S, cfg.snv) | ~contains[:, 0]
    if oracle.bloom.is_counting and cfg.min_threshold > 1:
        gate |= counts[:, 0] < cfg.min_threshold
    return ConfirmResult(miss.sum(1), there.sum(1), med, bad_any.any(1), gate)


def subs_batch(oracle, W: np.ndarray, draft_chars: np.ndarray):
    """Substitution pre-checks + verify scans for all alternates of S sites.

    Returns (alts [S,4] ASCII or 0-pad, pre_ok [S,4], present [S,4])."""
    cfg = oracle.cfg
    k = cfg.k
    S = W.shape[0]
    tab = oracle.bases_tab
    alts = np.zeros((S, 4), dtype=np.uint8)
    for s in range(S):
        a = tab.get(chr(draft_chars[s]), "")
        for i, ch in enumerate(a):
            alts[s, i] = ord(ch)
    flat_alts = alts.reshape(-1)
    live_idx = np.nonzero(flat_alts > 0)[0]
    # phase 1: pre-check just the substituted k-mer itself (contains+solid,
    # ntedit.cpp:1923-1928) — one window per (site, alt)
    first = W[live_idx // 4, :k].copy()
    first[:, k - 1] = flat_alts[live_idx]
    c0, s0, _ = _bulk(oracle, first)
    pre_ok = np.zeros(S * 4, dtype=bool)
    pre_ok[live_idx] = c0[:, 0] & s0[:, 0]
    # phase 2: the k-roll verify scan only where a trial will actually run
    # (pre-check passed, or mode 2 which always verifies) — on real drafts
    # only ~1 of 3 alternates passes the pre-check, so this skips ~2/3 of
    # the batch hashing
    need_idx = live_idx if cfg.mode == 2 else np.nonzero(pre_ok)[0]
    present = np.zeros(S * 4, dtype=np.int64)
    if len(need_idx):
        rows = W[need_idx // 4, : 2 * k].copy()
        rows[:, k - 1] = flat_alts[need_idx]
        contains, solid, _ = _bulk(oracle, rows)
        kk = np.arange(k)
        stride = (kk % cfg.jump) == 0
        present[need_idx] = (
            stride[None, :] & contains[:, 1 : k + 1] & solid[:, 1 : k + 1]
        ).sum(1)
    return alts, pre_ok.reshape(S, 4), present.reshape(S, 4)


def indel_batch(oracle, W: np.ndarray, index_chars: np.ndarray, del_starts: np.ndarray,
                los: Optional[np.ndarray] = None, his: Optional[np.ndarray] = None):
    """Insertion + deletion trial supports for N (site, alternate) pairs.

    W [N, span]; index_chars [N] (the alternate base anchoring the insertion
    table); del_starts [N] (each pair's current shared deletion counter).
    los/his [N] bound the insertion-string range evaluated per pair
    ([0, n_tries) by default) — the mode-0 driver stages trials by length
    because the first qualifying candidate wins by rank and real indels are
    short.  Deletions are evaluated only for pairs with lo == 0 (they
    interleave at iteration ranks < 2*n_tries and all fit in stage one).
    Returns (ins_support [N, n_tries] with -1 outside [lo, hi),
    del_support [N, max_d+1] with column d-1 = support of deletion length
    d, -1 where not tried)."""
    cfg = oracle.cfg
    k = cfg.k
    N = W.shape[0]
    n_tries = NUM_TRIES[cfg.max_insertions]
    if los is None:
        los = np.zeros(N, dtype=np.int64)
    if his is None:
        his = np.full(N, n_tries, dtype=np.int64)
    los = np.asarray(los, dtype=np.int64)
    his = np.asarray(his, dtype=np.int64)
    index_chars = np.asarray(index_chars, dtype=np.uint8)
    ins_support = np.full((N, max(n_tries, 1)), -1, dtype=np.int64)
    width = 2 * k + 4
    counts = np.maximum(his - los, 0)
    rows_n = np.repeat(np.arange(N), counts)
    if len(rows_n):
        rows_i = (
            np.concatenate([np.arange(lo, hi) for lo, hi in zip(los, his) if hi > lo])
            if counts.any() else np.zeros(0, dtype=np.int64)
        )
        all_rows = np.empty((len(rows_n), width), dtype=np.uint8)
        row_chars = index_chars[rows_n]
        for c in b"ACGT":
            m = row_chars == c
            if not m.any():
                continue
            src, cval = _ins_templates(chr(c), k, n_tries, width)
            s = np.minimum(src[rows_i[m]], W.shape[1] - 1)
            cv = cval[rows_i[m]]
            gathered = np.take_along_axis(W[rows_n[m]], s, axis=1)
            all_rows[m] = np.where(cv > 0, cv, gathered)
        contains, solid, _ = _bulk(oracle, all_rows)
        kk = np.arange(k - 1)
        stride = (kk % cfg.jump) == 0
        sup = (stride[None, :] & contains[:, 1:k] & solid[:, 1:k]).sum(1)
        ins_support[rows_n, rows_i] = sup

    max_d = cfg.max_deletions
    del_support = np.full((N, max_d + 1), -1, dtype=np.int64)
    if max_d and n_tries:
        dn_mask = los == 0
        dcounts = np.where(dn_mask, np.maximum(max_d + 1 - del_starts, 0), 0)
        dn = np.repeat(np.arange(N), dcounts)
        if len(dn):
            dd = np.concatenate(
                [np.arange(int(s), max_d + 1) for n, s in enumerate(del_starts) if dcounts[n] > 0]
            )
            src_d = _del_templates(k, max_d)
            drows = np.take_along_axis(W[dn], src_d[dd - 1], axis=1)
            contains, solid, _ = _bulk(oracle, drows)
            dkk = np.arange(1, k - 1)
            dstride = (dkk % cfg.jump) == 0
            sup = (
                (contains[:, 0] & solid[:, 0]).astype(np.int64)
                + (dstride[None, :] & contains[:, dkk] & solid[:, dkk]).sum(1)
            )
            del_support[dn, dd - 1] = sup
    return ins_support, del_support


_INS_TEMPL: dict = {}
_DEL_TEMPL: dict = {}


def _ins_templates(c: str, k: int, n_tries: int, width: int):
    """Per-anchor-char gather templates for insertion trial rows:
    src[i, j] = W column feeding output column j for trial i, and
    cval[i, j] = the inserted constant byte (0 = take from W)."""
    key = (c, k, n_tries, width)
    t = _INS_TEMPL.get(key)
    if t is None:
        src = np.zeros((max(n_tries, 1), width), dtype=np.int64)
        cval = np.zeros((max(n_tries, 1), width), dtype=np.uint8)
        j = np.arange(width)
        for i, ins in enumerate(MULTI_POSSIBLE_BASES[c][:n_tries]):
            li = len(ins)
            src[i] = np.where(j < k - 1, j, np.maximum(j - li, 0))
            cval[i, k - 1 : k - 1 + li] = np.frombuffer(ins.encode(), np.uint8)
        t = _INS_TEMPL[key] = (src, cval)
    return t


def _del_templates(k: int, max_d: int):
    """src_d[d-1, j]: W column for output column j of the length-d deletion
    row (W[:k-1] ++ W[k-1+d : k-1+d+k])."""
    key = (k, max_d)
    t = _DEL_TEMPL.get(key)
    if t is None:
        t = _DEL_TEMPL[key] = np.stack(
            [
                np.concatenate(
                    [np.arange(k - 1), np.arange(k - 1 + d, k - 1 + d + k)]
                )
                for d in range(1, max_d + 1)
            ]
        )
    return t


def arbitrate_indels(cfg, ins_support, del_support, index_char: int,
                     del_state, best: dict, w: np.ndarray) -> bool:
    """Winner arbitration for one tryIndels call (ntedit.cpp:1548-1744),
    replaying the interleaved trial order over precomputed supports.
    Mutates ``best`` / ``del_state`` exactly like the scalar path."""
    k = cfg.k
    n_tries = NUM_TRIES[cfg.max_insertions]
    if n_tries == 0:
        return False
    ins_list = MULTI_POSSIBLE_BASES[chr(index_char)]
    s = del_state[0]
    # interleaved candidates: insertion i at rank 2i; the deletion tried at
    # iteration i (length s+i, while <= max_d) at rank 2i+1
    candidates = []
    ins_qual = ins_support[:n_tries] >= cfg.present_needed
    for i in np.nonzero(ins_qual)[0]:
        candidates.append((2 * int(i), 2, int(ins_support[i]), ins_list[int(i)]))
    for d in range(s, cfg.max_deletions + 1):
        i = d - s
        if i >= n_tries:
            break
        sup = int(del_support[d - 1])
        if sup >= cfg.present_needed_deletion:
            deleted = w[k - 1 : k - 1 + d].tobytes().decode()
            candidates.append((2 * i + 1, 3, sup, deleted))
    # advance the shared deletion counter like the scalar loop
    if s <= cfg.max_deletions:
        iters = n_tries
        del_state[0] = min(cfg.max_deletions, s + iters - 1) + 1
    candidates.sort(key=lambda c: c[0])
    if not candidates:
        return False
    if cfg.mode == 0:
        _rank, typ, sup, payload = candidates[0]
        best.update(type=typ, indel=payload, support=sup)
        return True
    t_best_sup = 0
    t_alt_sup = 0
    t_best = None
    t_alt = None
    for _rank, typ, sup, payload in candidates:
        if sup >= t_best_sup:
            if t_best_sup:
                t_alt, t_alt_sup = t_best, t_best_sup
            t_best, t_best_sup = (typ, payload), sup
    if (cfg.mode == 2 and t_best_sup > best["support"]) or cfg.mode == 1:
        best.update(
            type=t_best[0], indel=t_best[1], support=t_best_sup,
            alt_indel=t_alt[1] if t_alt else "",
        )
        best["altsupp1"] = t_alt_sup
    return True


def decide_simple_batch(oracle, conf, draft_chars, alts, pre_ok, present,
                        attempt):
    """Vectorized decision replay for sites that will issue NO indel
    requests — the overwhelmingly common case (an error site's true base
    passes the pre-check and verifies).  Replays the exact shuffle_best
    insertion algorithm (ntedit.cpp:2008-2056) across all S sites at once,
    sequentially over the <=4 alternates.

    Returns (simple [S] bool, bests) where bests[i] is the finished best
    dict for simple sites with attempt (None entries elsewhere).  Sites
    with simple[i] False must go through the generator path."""
    cfg = oracle.cfg
    S = len(draft_chars)
    live = alts > 0
    if cfg.mode == 2:
        qual = live & (present >= cfg.present_needed)
    else:
        qual = pre_ok & (present >= cfg.present_needed)
    n_tries = NUM_TRIES[cfg.max_insertions]
    no_indel_cfg = n_tries == 0 and cfg.max_deletions == 0
    if no_indel_cfg:
        simple = np.ones(S, dtype=bool)
    elif cfg.mode == 2:
        simple = np.zeros(S, dtype=bool)  # mode 2 always tries indels
    else:
        prev_qual = np.zeros((S, 4), dtype=bool)
        prev_qual[:, 1:] = np.cumsum(qual, axis=1)[:, :3] > 0
        # an alt that passed the pre-check but failed verify, before any
        # qualifying substitution, triggers tryIndels (ntedit.cpp:2065-2090)
        simple = ~(pre_ok & ~qual & ~prev_qual).any(axis=1)
    simple = simple & attempt
    if not simple.any():
        return simple, [None] * S

    typ = np.zeros(S, dtype=np.int64)
    sub = np.zeros(S, dtype=np.int64)
    sup = np.zeros(S, dtype=np.int64)
    ab = np.zeros((3, S), dtype=np.int64)
    asup = np.zeros((3, S), dtype=np.int64)
    if cfg.snv:
        base_ok = conf.check_there >= cfg.present_needed
        bsup = (
            conf.there_median if oracle.bloom.is_counting else conf.check_there
        ).astype(np.int64)
        sub = np.where(base_ok, draft_chars.astype(np.int64), sub)
        sup = np.where(base_ok, bsup, sup)

    for a in range(4):
        m = simple & qual[:, a]
        if not m.any():
            continue
        p = present[:, a]
        alt = alts[:, a].astype(np.int64)
        ge = m & (p >= sup)
        # snapshot, then cascade (shuffle_best's displacement order)
        o_sub, o_sup = sub.copy(), sup.copy()
        o_ab1, o_as1 = ab[0].copy(), asup[0].copy()
        o_ab2, o_as2 = ab[1].copy(), asup[1].copy()
        c3 = ge & (o_as2 > 0)
        ab[2] = np.where(c3, o_ab2, ab[2]); asup[2] = np.where(c3, o_as2, asup[2])
        c2 = ge & (o_as1 > 0)
        ab[1] = np.where(c2, o_ab1, ab[1]); asup[1] = np.where(c2, o_as1, asup[1])
        c1 = ge & (o_sup > 0)
        ab[0] = np.where(c1, o_sub, ab[0]); asup[0] = np.where(c1, o_sup, asup[0])
        typ = np.where(ge, 1, typ)
        sub = np.where(ge, alt, sub)
        sup = np.where(ge, p, sup)
        # the below-best insertion branches
        lt = m & ~ge
        no1 = lt & (o_as1 == 0)
        ab[0] = np.where(no1, alt, ab[0]); asup[0] = np.where(no1, p, asup[0])
        slot2 = lt & (o_as1 > 0) & (o_as2 == 0)
        s2lo = slot2 & (p < o_as1)
        ab[1] = np.where(s2lo, alt, ab[1]); asup[1] = np.where(s2lo, p, asup[1])
        s2hi = slot2 & ~s2lo
        ab[1] = np.where(s2hi, o_ab1, ab[1]); asup[1] = np.where(s2hi, o_as1, asup[1])
        ab[0] = np.where(s2hi, alt, ab[0]); asup[0] = np.where(s2hi, p, asup[0])
        slot3 = lt & (o_as1 > 0) & (o_as2 > 0) & (asup[2] == 0) & ~c3
        s3lo = slot3 & (p < o_as2)
        ab[2] = np.where(s3lo, alt, ab[2]); asup[2] = np.where(s3lo, p, asup[2])
        s3mid = slot3 & ~s3lo & (p < o_as1)
        ab[2] = np.where(s3mid, o_ab2, ab[2]); asup[2] = np.where(s3mid, o_as2, asup[2])
        ab[1] = np.where(s3mid, alt, ab[1]); asup[1] = np.where(s3mid, p, asup[1])
        s3hi = slot3 & ~s3lo & ~s3mid
        ab[2] = np.where(s3hi, o_ab2, ab[2]); asup[2] = np.where(s3hi, o_as2, asup[2])
        ab[1] = np.where(s3hi, o_ab1, ab[1]); asup[1] = np.where(s3hi, o_as1, asup[1])
        ab[0] = np.where(s3hi, alt, ab[0]); asup[0] = np.where(s3hi, p, asup[0])

    bests = [None] * S
    for i in np.nonzero(simple)[0]:
        bests[i] = dict(
            type=int(typ[i]), sub_base=int(sub[i]), indel="", alt_indel="",
            support=int(sup[i]),
            altbase1=int(ab[0][i]), altsupp1=int(asup[0][i]),
            altbase2=int(ab[1][i]), altsupp2=int(asup[1][i]),
            altbase3=int(ab[2][i]), altsupp3=int(asup[2][i]),
        )
    return simple, bests


def empty_best() -> dict:
    return dict(
        type=0, sub_base=0, indel="", alt_indel="", support=0,
        altbase1=0, altsupp1=0, altbase2=0, altsupp2=0, altbase3=0, altsupp3=0,
    )


def decide_site_gen(oracle, w: np.ndarray, draft_char: int, conf: ConfirmResult,
                    s_idx: int, alts_row, pre_ok_row, present_row):
    """Replay the sequential decision for one site over precomputed
    substitution data, as a generator.  Yields ``(index_char, del_start)``
    whenever indel trials are needed (the driver batches those across sites
    and ``send``s back ``(ins_sup_row, del_sup_row)``).  Returns (via
    StopIteration.value) the final ``best`` dict, or None when no fix is
    attempted."""
    cfg = oracle.cfg
    attempt = cfg.snv or (
        not conf.do_not_fix[s_idx]
        and (
            conf.check_missing[s_idx] >= cfg.missing_needed
            or (oracle.bloom.is_counting and conf.there_median[s_idx] < cfg.min_threshold)
        )
    )
    if not attempt:
        return None
    best = empty_best()
    del_state = [1]
    if cfg.snv and conf.check_there[s_idx] >= cfg.present_needed:
        best["sub_base"] = draft_char
        best["support"] = int(
            conf.there_median[s_idx] if oracle.bloom.is_counting else conf.check_there[s_idx]
        )
    for a in range(4):
        if alts_row[a] == 0:
            break
        sub_base = int(alts_row[a])
        if pre_ok_row[a] or cfg.mode == 2:
            check_present = int(present_row[a])
            if check_present >= cfg.present_needed:
                shuffle_best(best, sub_base, check_present)
                if cfg.mode in (0, 1):
                    continue
            if cfg.mode == 2 or best["type"] != 1:
                n_tries = NUM_TRIES[cfg.max_insertions]
                # mode 0 takes the lowest-ranked qualifying candidate, and
                # stage-one ranks (insertions of length <= 3, every
                # deletion) all precede stage-two ranks — so the expensive
                # long-insertion batch runs only when stage one is empty
                stage_hi = 21 if (cfg.mode == 0 and n_tries > 21) else n_tries
                s0 = del_state[0]
                ins_sup, del_sup = yield (sub_base, s0, 0, stage_hi)
                found = arbitrate_indels(
                    cfg, ins_sup, del_sup, sub_base, del_state, best, w
                )
                if not found and stage_hi < n_tries:
                    sup_b, _ = yield (sub_base, s0, stage_hi, n_tries)
                    merged = np.maximum(ins_sup, sup_b)
                    del_state[0] = s0  # re-arbitrate from the original counter
                    found = arbitrate_indels(
                        cfg, merged, del_sup, sub_base, del_state, best, w
                    )
                if found and cfg.mode in (0, 1):
                    break
    return best


def run_decider(oracle, gen, w: np.ndarray):
    """Drive a decide_site_gen unbatched (single-site use): evaluate each
    indel request immediately.  Returns the final best dict (or None)."""
    try:
        req = gen.send(None)
        while True:
            index_char, del_start, lo, hi = req
            ins_sup, del_sup = indel_batch(
                oracle, w[None], np.array([index_char]), np.array([del_start]),
                np.array([lo]), np.array([hi]),
            )
            req = gen.send((ins_sup[0], del_sup[0]))
    except StopIteration as stop:
        return stop.value


# ---------------------------------------------------------------------------
# Single-site entry (used by the sequential fast path)
# ---------------------------------------------------------------------------

def site_pristine(oracle, h_idx: int, base_seq: int) -> bool:
    cells = oracle.cells
    span = span_for(oracle.cfg)
    if hasattr(cells, "pristine_run"):
        return cells.pristine_run(h_idx, span) == base_seq
    if h_idx + span > len(cells):
        return False
    for i in range(span):
        if cells[h_idx + i][ORIG] != base_seq + i:
            return False
    return True


def try_fix_site_fast(oracle, draft_char: int, st, fh, rh):
    """Vectorized equivalent of Oracle._fix_site for one pristine site.
    Returns (fh, rh, edited) or None if ineligible (fallback to scalar)."""
    cfg = oracle.cfg
    if not site_pristine(oracle, st[0], st[1]):
        return None
    span = span_for(cfg)
    w = np.frombuffer(bytes(oracle.contig[st[1] : st[1] + span]), dtype=np.uint8)
    dc = np.array([draft_char], dtype=np.uint8)
    conf = confirm_batch(oracle, w[None], dc)
    # quick exit without substitution batching when no attempt will happen
    attempt = cfg.snv or (
        not conf.do_not_fix[0]
        and (
            conf.check_missing[0] >= cfg.missing_needed
            or (oracle.bloom.is_counting and conf.there_median[0] < cfg.min_threshold)
        )
    )
    if not attempt:
        return fh, rh, False
    alts, pre_ok, present = subs_batch(oracle, w[None], dc)
    gen = decide_site_gen(oracle, w, draft_char, conf, 0, alts[0], pre_ok[0], present[0])
    best = run_decider(oracle, gen, w)
    if best is None:
        return fh, rh, False
    return oracle._make_edit(draft_char, best, st, fh, rh)
