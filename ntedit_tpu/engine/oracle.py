"""Scalar oracle: the executable specification of the ntEdit polishing /
SNV algorithm.

This is a from-scratch Python implementation of the algorithm contract
documented in SURVEY.md §2.4 (reference: /root/reference/ntedit.cpp,
``kmerizeAndCorrect`` 1747-2151, ``tryIndels`` 1548-1744, ``tryDeletion``
1451-1545, ``makeEdit`` 1250-1448, rope ops 613-922).  It exists to be
*read and trusted*: every vectorized device engine pass is property-tested
for equivalence against this oracle, and the C++ CPU baseline implements
the same spec.

Representation: instead of the reference's seqNode rope (a memory
optimization for hundred-Mbp contigs), the oracle keeps an explicit cell
list — one cell per current sequence character, carrying its original
coordinate (or -1 for inserted bases) plus support metadata.  All rope
traversal semantics (roll, increment, seq_i coordinate tracking) reduce to
flat indexing; the correspondence is documented inline.

Deliberate clean-spec deviations from the reference C++ (each is a
node-boundary-dependent defect of the rope implementation that cannot be
expressed over sequence content alone) are listed in FIDELITY.md.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ntedit_tpu.core import nthash_ref as nh
from ntedit_tpu.engine.config import (
    ACCEPTED,
    ACGT,
    EngineConfig,
    MULTI_POSSIBLE_BASES,
    NUM_TRIES,
    POLISH_BASES,
    SNV_BASES,
    rc_char,
)

# cell field indices
ORIG = 0   # original coordinate, -1 for inserted characters
CHAR = 1   # character (only authoritative for inserted cells)
INS_SUP = 2  # insertion support (rope char-node num_support)
SPAN_SUP = 3  # deletion support marker (rope node num_support after a gap)


@dataclasses.dataclass(slots=True)
class SubRec:
    """sRec (ntedit.cpp:598-611)."""

    pos: int
    draft_char: int
    sub_base: int
    num_support: int
    altbase1: int = 0
    altsupp1: int = 0
    altbase2: int = 0
    altsupp2: int = 0
    altbase3: int = 0
    altsupp3: int = 0


class RopeCells:
    """seqNode rope (the reference's edit structure, ntedit.cpp:613-620)
    behind a minimal cell-list facade.

    ``nodes`` is a list of ["span", s_pos, e_pos, sup] (a contiguous range
    of the original contig; the reference's type-0 node) and ["ins", cell]
    (one inserted character; type-1), where ``cell`` is a mutable
    [-1, char, support, 0] list whose identity is preserved across
    __getitem__ so in-place field writes stick.  Span cells are read-only
    views (their edits go through ``contig``); the one span-cell field
    write the engine performs (post-deletion support, makeDeletion's record
    at ntedit.cpp:719-809) goes through set_span_sup, which splits the
    node.  Construction is O(1) and splices are O(nodes), so a contig pays
    for its edits, not its length."""

    __slots__ = ("nodes", "_cum", "_len")

    def __init__(self, n: int):
        self.nodes = [["span", 0, n - 1, 0]] if n else []
        self._cum = None
        self._len = n

    # -- index mapping --
    def _cumlens(self) -> np.ndarray:
        if self._cum is None:
            lens = [
                nd[2] - nd[1] + 1 if nd[0] == "span" else 1 for nd in self.nodes
            ]
            self._cum = np.concatenate(
                [np.zeros(1, dtype=np.int64), np.cumsum(lens, dtype=np.int64)]
            )
        return self._cum

    def _locate(self, i: int):
        cum = self._cumlens()
        ni = int(np.searchsorted(cum, i, side="right")) - 1
        return ni, i - int(cum[ni])

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(self._len)
            return [self[j] for j in range(start, stop, step)]
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError(i)
        ni, off = self._locate(i)
        nd = self.nodes[ni]
        if nd[0] == "span":
            return [nd[1] + off, 0, 0, nd[3]]
        return nd[1]

    def __iter__(self):
        for nd in self.nodes:
            if nd[0] == "span":
                for p in range(nd[1], nd[2] + 1):
                    yield [p, 0, 0, nd[3]]
            else:
                yield nd[1]

    # -- structural edits --
    def _split_at(self, i: int) -> int:
        """Ensure a node boundary at cell index i; return the index of the
        node that starts at i (== len(nodes) when i == len(self))."""
        if i == self._len:
            return len(self.nodes)
        ni, off = self._locate(i)
        if off == 0:
            return ni
        nd = self.nodes[ni]  # mid-span (ins nodes have length 1)
        self.nodes[ni] = ["span", nd[1], nd[1] + off - 1, nd[3]]
        self.nodes.insert(ni + 1, ["span", nd[1] + off, nd[2], nd[3]])
        if self._cum is not None:  # incremental: one boundary appears
            self._cum = np.insert(self._cum, ni + 1, self._cum[ni] + off)
        return ni + 1

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            start, stop, _ = i.indices(self._len)
            if start != stop:
                raise NotImplementedError("rope supports insertion splices only")
            ni = self._split_at(start)
            m = len(v)
            self.nodes[ni:ni] = [["ins", c] for c in v]
            if self._cum is not None:  # m unit-length boundaries appear
                cum = self._cum
                self._cum = np.concatenate(
                    [cum[: ni + 1], cum[ni] + 1 + np.arange(m), cum[ni + 1 :] + m]
                )
            self._len += m
            return
        raise NotImplementedError("single-cell assignment not used by the engine")

    def __delitem__(self, i):
        if not isinstance(i, slice):
            i = slice(i, i + 1)
        start, stop, _ = i.indices(self._len)
        if start >= stop:
            return
        a = self._split_at(start)
        b = self._split_at(stop)
        del self.nodes[a:b]
        if self._cum is not None:
            cum = self._cum
            self._cum = np.concatenate([cum[: a + 1], cum[b + 1 :] - (stop - start)])
        self._len -= stop - start

    def walk(self, lo: int, n: int):
        """Yield cells [lo, lo+n) as (orig, char) pairs in one node walk
        (no per-index bisection).  orig < 0 marks an inserted cell whose
        byte is ``char``; span cells yield (orig, -1)."""
        if n <= 0 or lo >= self._len:
            return
        ni, off = self._locate(lo)
        remaining = min(n, self._len - lo)
        while remaining > 0 and ni < len(self.nodes):
            nd = self.nodes[ni]
            if nd[0] == "span":
                start = nd[1] + off
                cnt = min(nd[2] - start + 1, remaining)
                for p in range(start, start + cnt):
                    yield (p, -1)
                remaining -= cnt
            else:
                yield (-1, nd[1][CHAR])
                remaining -= 1
            ni += 1
            off = 0

    def pristine_run(self, idx: int, n: int):
        """If cells [idx, idx+n) form one coordinate-contiguous run of
        ORIGINAL cells, return the run's starting contig coordinate, else
        None.  O(log nodes + nodes crossed) — the per-cell __getitem__ loop
        this replaces dominated the wavefront profile."""
        if idx < 0 or idx + n > self._len:
            return None
        ni, off = self._locate(idx)
        nd = self.nodes[ni]
        if nd[0] != "span":
            return None
        start = nd[1] + off
        covered = nd[2] - start + 1
        expect = nd[2] + 1
        while covered < n:
            ni += 1
            nd = self.nodes[ni]
            if nd[0] != "span" or nd[1] != expect:
                return None
            covered += nd[2] - nd[1] + 1
            expect = nd[2] + 1
        return start

    def seq_at(self, idx: int, L: int) -> int:
        """Contig coordinate of cell idx (the _seq_of convention: an
        original cell maps to its own coordinate; otherwise nearest-
        previous-original + 1; 0 when no original cell precedes idx)."""
        if 0 <= idx < self._len:
            ni, off = self._locate(idx)
            nd = self.nodes[ni]
            if nd[0] == "span":
                return nd[1] + off
        else:
            if self._len == 0:
                return 0
            ni = len(self.nodes)  # scan back from the last node
        while ni > 0:
            ni -= 1
            nd = self.nodes[ni]
            if nd[0] == "span":
                return nd[2] + 1
        return 0

    def seq_of_many(self, idxs: np.ndarray) -> np.ndarray:
        """Vectorized seq_at over sorted in-range cell indices."""
        cum = self._cumlens()
        arr = np.asarray(idxs, dtype=np.int64)
        ni = np.searchsorted(cum, arr, side="right") - 1
        nodes = self.nodes
        is_span = np.fromiter(
            (nd[0] == "span" for nd in nodes), dtype=bool, count=len(nodes)
        )
        s_pos = np.fromiter(
            (nd[1] if nd[0] == "span" else 0 for nd in nodes),
            dtype=np.int64, count=len(nodes),
        )
        e_pos = np.fromiter(
            (nd[2] if nd[0] == "span" else -1 for nd in nodes),
            dtype=np.int64, count=len(nodes),
        )
        # seq value an INSERTED cell in node i maps to: end+1 of the nearest
        # span node strictly before i (coordinates are monotone along the
        # rope, so "nearest before" == running max)
        run = np.maximum.accumulate(np.where(is_span, e_pos + 1, 0))
        prev_span_end = np.concatenate([[0], run[:-1]])
        out = np.where(
            is_span[ni], s_pos[ni] + (arr - cum[ni]), prev_span_end[ni]
        )
        return out

    def compat_deletion_len(self, idx: int, n_del: int) -> int:
        """Effective deletion length under reference rope semantics
        (rope_compat): ``makeDeletion`` computes
        ``leftover_del = pos + num_del - e_pos`` when a deletion consumes a
        type-0 node past its end (ntedit.cpp:739,767) — one more than the
        clean remainder — so every span-node exit adds one extra deleted
        base, cascading; a leftover with no following node is dropped
        (ntedit.cpp:773-780).  Char (insertion) nodes consume without the
        off-by-one (ntedit.cpp:782-808).  Node boundaries in this rope are
        exactly the reference's: both structures split only at edit sites
        (set_span_sup never splits in practice — the deletion path has
        already placed a boundary at the support cell)."""
        if idx >= self._len:
            return 0
        ni, off = self._locate(idx)
        remaining = n_del
        total = 0
        while remaining > 0 and ni < len(self.nodes):
            nd = self.nodes[ni]
            if nd[0] == "span":
                avail = (nd[2] - nd[1] + 1) - off
                if remaining < avail:
                    total += remaining
                    remaining = 0
                else:
                    total += avail
                    remaining = remaining - avail + 1  # the off-by-one
            else:
                # consecutive char nodes consume one each, exactly
                take = 1 if remaining >= 1 else 0
                total += take
                remaining -= take
            ni += 1
            off = 0
        return min(total, self._len - idx)

    def set_span_sup(self, i: int, sup: int) -> None:
        ni = self._split_at(i)
        nd = self.nodes[ni]
        if nd[0] == "span":
            nd[3] = sup
        else:
            nd[1][3] = sup
        # a mid-span split leaves two coordinate-contiguous span nodes; the
        # writers merge those back into one run, reproducing the cell-list
        # behavior (a mid-run support write is invisible until a deletion
        # gap starts a run there)


def make_sub_rec(draft_char: int, best: dict, pos: int) -> "SubRec":
    """Substitution record with ranked-alternate de-duplication
    (writeEditsToFile record layout, ntedit.cpp:992-1052)."""
    rec = SubRec(
        pos=pos, draft_char=draft_char, sub_base=best["sub_base"],
        num_support=best["support"],
    )
    if best["altsupp1"] and best["altbase1"] != best["sub_base"]:
        rec.altbase1, rec.altsupp1 = best["altbase1"], best["altsupp1"]
    if best["altsupp2"] and best["altbase2"] != best["altbase1"]:
        rec.altbase2, rec.altsupp2 = best["altbase2"], best["altsupp2"]
    if best["altsupp3"] and best["altbase3"] != best["altbase2"]:
        rec.altbase3, rec.altsupp3 = best["altbase3"], best["altsupp3"]
    return rec


def set_span_sup(cells, idx: int, sup: int) -> None:
    """Record post-deletion support on the cell at idx (facade-aware)."""
    if isinstance(cells, RopeCells):
        cells.set_span_sup(idx, sup)
    else:
        cells[idx][SPAN_SUP] = sup


@dataclasses.dataclass
class ContigResult:
    header: str
    contig: bytearray          # original-length sequence with subs/masks applied
    cells: list                # current cell list (the edited sequence)
    subs: list                 # queued SubRec in scan order

    @property
    def edited(self) -> bytes:
        nodes = getattr(self.cells, "nodes", None)
        if nodes is not None:
            parts = []
            for nd in nodes:
                if nd[0] == "span":
                    parts.append(bytes(self.contig[nd[1] : nd[2] + 1]))
                else:
                    parts.append(bytes([nd[1][CHAR]]))
            return b"".join(parts)
        out = bytearray()
        for c in self.cells:
            out.append(self.contig[c[ORIG]] if c[ORIG] >= 0 else c[CHAR])
        return bytes(out)


class BFLike:
    """BFWrapper equivalent (ntedit.cpp:350-401) over host filters."""

    def __init__(self, bf):
        self.bf = bf
        self.is_counting = hasattr(bf, "counters")

    def contains(self, hashes: np.ndarray) -> bool:
        if self.is_counting:
            return bool(self.bf.count_hashes(hashes[None])[0] > 0)
        return bool(self.bf.contains_hashes(hashes[None])[0])

    def get_count(self, hashes: np.ndarray) -> int:
        if self.is_counting:
            return int(self.bf.count_hashes(hashes[None])[0])
        return 1


def median_u8(vec: list) -> int:
    """Reference median(): sorted()[len/2], 0 for empty (ntedit.cpp:454-463)."""
    if not vec:
        return 0
    s = sorted(vec)
    return s[len(s) // 2]


def is_accepted(c: int) -> bool:
    return c in ACCEPTED


def is_atgc(c: int) -> bool:
    return c in ACGT


def find_first_accepted_kmer(start: int, contig: bytes, k: int) -> int:
    """findFirstAcceptedKmer (ntedit.cpp:524-545), including its quirk of
    only considering windows with i + k < len (the final window at L-k is
    unreachable by the initial seek)."""
    i = start
    L = len(contig)
    while i + k < L:
        if is_accepted(_upper(contig[i])):
            good = True
            for j in range(i + 1, i + k):
                if not is_accepted(_upper(contig[j])):
                    good = False
                    i = j + 1
                    break
            if good:
                return i
        else:
            i += 1
    return L - 1


def _upper(c: int) -> int:
    return c - 32 if 97 <= c <= 122 else c


def shuffle_best(b: dict, sub_base: int, check_present: int) -> None:
    """Best-substitution/alternate bookkeeping (ntedit.cpp:2008-2056):
    a qualifying substitution with support >= current best replaces it,
    cascading the old best into the ranked alternates; otherwise it is
    inserted into the alternates by support."""
    if check_present >= b["support"]:
        if b["altsupp2"]:
            b["altbase3"], b["altsupp3"] = b["altbase2"], b["altsupp2"]
        if b["altsupp1"]:
            b["altbase2"], b["altsupp2"] = b["altbase1"], b["altsupp1"]
        if b["support"]:
            b["altbase1"], b["altsupp1"] = b["sub_base"], b["support"]
        b["type"] = 1
        b["sub_base"] = sub_base
        b["support"] = check_present
    else:
        if not b["altsupp1"]:
            b["altbase1"], b["altsupp1"] = sub_base, check_present
        elif not b["altsupp2"]:
            if check_present < b["altsupp1"]:
                b["altbase2"], b["altsupp2"] = sub_base, check_present
            else:
                b["altbase2"], b["altsupp2"] = b["altbase1"], b["altsupp1"]
                b["altbase1"], b["altsupp1"] = sub_base, check_present
        elif not b["altsupp3"]:
            if check_present < b["altsupp2"]:
                b["altbase3"], b["altsupp3"] = sub_base, check_present
            elif check_present < b["altsupp1"]:
                b["altbase3"], b["altsupp3"] = b["altbase2"], b["altsupp2"]
                b["altbase2"], b["altsupp2"] = sub_base, check_present
            else:
                b["altbase3"], b["altsupp3"] = b["altbase2"], b["altsupp2"]
                b["altbase2"], b["altsupp2"] = b["altbase1"], b["altsupp1"]
                b["altbase1"], b["altsupp1"] = sub_base, check_present


def is_repeat_insertion(s: str) -> bool:
    """KMP failure-function periodicity test (ntedit.cpp:560-596)."""
    n = len(s)
    if n == 0:
        return False
    lps = [0] * n
    ln = 0
    i = 1
    while i < n:
        if s[i] == s[ln]:
            ln += 1
            lps[i] = ln
            i += 1
        elif ln != 0:
            ln = lps[ln - 1]
        else:
            lps[i] = 0
            i += 1
    ln = lps[n - 1]
    return ln > 0 and n % (n - ln) == 0


class Oracle:
    def __init__(self, bloom, bloomrep, cfg: EngineConfig, fast: bool = False):
        self.bloom = bloom if isinstance(bloom, BFLike) else BFLike(bloom)
        self.bloomrep = (
            None if bloomrep is None else (bloomrep if isinstance(bloomrep, BFLike) else BFLike(bloomrep))
        )
        self.cfg = cfg.validate()
        self.bases_tab = SNV_BASES if self.cfg.snv else POLISH_BASES
        # fast=True dispatches eligible flagged sites to the vectorized
        # fixer (ntedit_tpu.engine.sitefix); the scalar path remains the
        # spec and the fallback.
        self.fast = fast

    # -- hashing helpers ---------------------------------------------------
    def _hashes(self, fh, rh):
        return nh.extend_hashes(nh.canonical(fh, rh), self.cfg.k, self.cfg.hash_num)

    def _solid(self, hashes) -> bool:
        """is_kmer_solid (ntedit.cpp:465-473)."""
        cfg = self.cfg
        ok_rep = self.bloomrep is None or not self.bloomrep.contains(hashes)
        if self.bloom.is_counting:
            cnt = self.bloom.get_count(hashes)
            ok_cnt = cfg.min_threshold <= cnt <= cfg.max_threshold
        else:
            ok_cnt = True
        return ok_rep and ok_cnt

    # -- cell/cursor helpers ----------------------------------------------
    def _char_at(self, idx: int) -> int:
        c = self.cells[idx]
        return self.contig[c[ORIG]] if c[ORIG] >= 0 else c[CHAR]

    def _inc(self, idx: int, seq: int):
        """Rope increment() (ntedit.cpp:825-844) on the flat cell list:
        for span cells pos advances by one; landing on a span cell adopts
        its original coordinate."""
        if self.cells[idx][ORIG] >= 0:
            seq += 1
        idx += 1
        if idx < len(self.cells) and self.cells[idx][ORIG] >= 0:
            seq = self.cells[idx][ORIG]
        return idx, seq

    def _roll(self, st):
        """roll() (ntedit.cpp:1216-1247): advance the k-window one base.
        st = [h_idx, h_seq, t_idx, t_seq]; returns (ok, charOut, charIn)."""
        n = len(self.cells)
        if st[0] >= n:
            return False, 0, 0
        char_out = self._char_at(st[0])
        st[0], st[1] = self._inc(st[0], st[1])
        if st[2] >= n:
            return False, char_out, 0
        st[2], st[3] = self._inc(st[2], st[3])
        if st[2] >= n:
            return False, char_out, 0
        return True, char_out, self._char_at(st[2])

    def _find_accepted_kmer(self, st):
        """findAcceptedKmer (ntedit.cpp:846-903) from the current tail
        cursor; returns the k-mer bytes and updates st in place, or returns
        None with cursors at end."""
        k = self.cfg.k
        n = len(self.cells)
        i = st[2]
        while i < n:
            if is_accepted(_upper(self._char_at(i))):
                kmer = [self._char_at(i)]
                j = i
                bad_at = None
                while len(kmer) < k and j + 1 < n:
                    j += 1
                    c = self._char_at(j)
                    if not is_accepted(_upper(c)):
                        bad_at = j
                        break
                    kmer.append(c)
                if len(kmer) == k:
                    st[0], st[2] = i, j
                    st[1] = self._seq_of(i)
                    st[3] = self._seq_of(j)
                    return bytes(kmer)
                # resume scanning after the offending char (reference sets
                # i = j then increments, ntedit.cpp:877-881,897)
                i = (bad_at + 1) if bad_at is not None else (i + 1)
            else:
                i += 1
        st[0] = st[2] = n
        st[1] = st[3] = len(self.contig)
        return None

    def _seq_of(self, idx: int) -> int:
        """Rope seq-coordinate of a cell: its own original coordinate for
        span cells; for inserted cells, previous span coordinate + 1."""
        if idx < len(self.cells) and self.cells[idx][ORIG] >= 0:
            return self.cells[idx][ORIG]
        j = min(idx, len(self.cells)) - 1
        while j >= 0:
            if self.cells[j][ORIG] >= 0:
                return self.cells[j][ORIG] + 1
            j -= 1
        return 0

    def _prev_insertion(self, t_idx: int) -> str:
        """getPrevInsertion (ntedit.cpp:907-922): reverse-complement of the
        run of inserted cells immediately before the cursor."""
        out = []
        j = t_idx - 1
        while j >= 0 and self.cells[j][ORIG] < 0:
            out.append(chr(rc_char(self.cells[j][CHAR])))
            j -= 1
        return "".join(out)

    # -- trial machinery ---------------------------------------------------
    def _vtrace(self, kind: str, payload: str, check_present: int, med) -> None:
        """-v per-trial trace, matching the reference's output shape
        (ntedit.cpp:1524-1530 deletions, 1650-1657 insertions,
        1982-1990 substitutions)."""
        line = f"\t\t{kind}: {payload} check_present: {check_present}"
        if self.bloom.is_counting:
            line += f" check_present_median_coverage: {median_u8(med)}"
        print(line)

    def _try_deletion(self, draft_char, num_deletions, st, fh, rh):
        """tryDeletion (ntedit.cpp:1451-1545).  Returns (support, deleted)."""
        cfg = self.cfg
        tmp = list(st)
        deleted = []
        for _ in range(num_deletions):
            if tmp[2] >= len(self.cells):
                return 0, ""  # deletion runs past contig end (clean spec)
            deleted.append(self._char_at(tmp[2]))
            tmp[2], tmp[3] = self._inc(tmp[2], tmp[3])
        if tmp[2] >= len(self.cells):
            return 0, ""
        new_last = self._char_at(tmp[2])
        tfh = nh.change_last_forward(fh, draft_char, new_last)
        trh = nh.change_last_reverse(rh, cfg.k, draft_char, new_last)
        hv = self._hashes(tfh, trh)
        check_present = 0
        med = []
        if self.bloom.contains(hv) and self._solid(hv):
            check_present += 1
        for kk in range(1, cfg.k - 1):  # k = 1 .. k-2
            if tmp[0] >= len(self.cells):
                break
            ok, co, ci = self._roll(tmp)
            if ok:
                tfh = nh.next_forward_hash(tfh, cfg.k, co, ci)
                trh = nh.next_reverse_hash(trh, cfg.k, co, ci)
                hv = self._hashes(tfh, trh)
                if kk % cfg.jump == 0 and self.bloom.contains(hv) and self._solid(hv):
                    check_present += 1
                    if self.bloom.is_counting:
                        med.append(self.bloom.get_count(hv))
        deleted_str = "".join(map(chr, deleted))
        if cfg.verbose:
            self._vtrace("deleting", deleted_str, check_present, med)
        if check_present >= cfg.present_needed_deletion:
            return check_present, deleted_str
        return 0, ""

    def _try_indels(self, draft_char, index_char, del_state, st, fh, rh, best):
        """tryIndels (ntedit.cpp:1548-1744).  ``best`` is the shared
        best-edit dict; del_state is the per-site deletion counter (shared
        across alternate bases — it is passed by reference in the
        reference).  Returns True if an indel was found/kept."""
        cfg = self.cfg
        t_best_sup = 0
        t_alt_sup = 0
        t_best_indel = ""
        t_alt_indel = ""
        t_best_type = 0
        for i in range(NUM_TRIES[cfg.max_insertions]):
            ins = MULTI_POSSIBLE_BASES[chr(index_char)][i] + chr(draft_char)
            tmp = list(st)
            tfh = nh.change_last_forward(fh, draft_char, index_char)
            trh = nh.change_last_reverse(rh, cfg.k, draft_char, index_char)
            check_present = 0
            med = []
            kk = 0
            # phase 1: roll the remaining insertion chars in while the head
            # consumes buffer chars (ntedit.cpp:1607-1624)
            while kk < len(ins) - 1 and tmp[0] < len(self.cells):
                co = self._char_at(tmp[0])
                ci = ord(ins[kk + 1])
                tfh = nh.next_forward_hash(tfh, cfg.k, co, ci)
                trh = nh.next_reverse_hash(trh, cfg.k, co, ci)
                tmp[0], tmp[1] = self._inc(tmp[0], tmp[1])
                hv = self._hashes(tfh, trh)
                if kk % cfg.jump == 0 and self.bloom.contains(hv) and self._solid(hv):
                    check_present += 1
                    if self.bloom.is_counting:
                        med.append(self.bloom.get_count(hv))
                kk += 1
            # phase 2: continue through the draft (ntedit.cpp:1626-1645)
            while kk < cfg.k - 1 and tmp[0] < len(self.cells):
                ok, co, ci = self._roll(tmp)
                if ok:
                    tfh = nh.next_forward_hash(tfh, cfg.k, co, ci)
                    trh = nh.next_reverse_hash(trh, cfg.k, co, ci)
                    hv = self._hashes(tfh, trh)
                    if kk % cfg.jump == 0 and self.bloom.contains(hv) and self._solid(hv):
                        check_present += 1
                        if self.bloom.is_counting:
                            med.append(self.bloom.get_count(hv))
                kk += 1
            ins_str = ins[:-1]
            if cfg.verbose:
                self._vtrace("inserting", ins_str, check_present, med)
            if check_present >= cfg.present_needed:
                if cfg.mode == 0:
                    best.update(type=2, indel=ins_str, support=check_present)
                    return True
                if check_present >= t_best_sup:
                    if t_best_sup:
                        t_alt_indel, t_alt_sup = t_best_indel, t_best_sup
                    t_best_type, t_best_indel, t_best_sup = 2, ins_str, check_present
            if del_state[0] <= cfg.max_deletions:
                sup, deleted = self._try_deletion(draft_char, del_state[0], st, fh, rh)
                if sup > 0:
                    if cfg.mode == 0:
                        best.update(type=3, indel=deleted, support=sup)
                        return True
                    if sup >= t_best_sup:
                        if t_best_sup:
                            t_alt_indel, t_alt_sup = t_best_indel, t_best_sup
                        t_best_type, t_best_indel, t_best_sup = 3, deleted, sup
                del_state[0] += 1
        if t_best_sup > 0:
            # mode 2 only overrides a substitution when strictly better;
            # mode 1 overwrites unconditionally (ntedit.cpp:1732-1741)
            if (cfg.mode == 2 and t_best_sup > best["support"]) or cfg.mode == 1:
                best.update(
                    type=t_best_type, indel=t_best_indel, support=t_best_sup,
                    alt_indel=t_alt_indel,
                )
                best["altsupp1"] = t_alt_sup
            return True
        return False

    # -- edit application --------------------------------------------------
    def commit_sub_pristine(self, draft_char, best, pos: int) -> None:
        """Substitution commit at a pristine ORIGINAL cell: record + in-
        place contig write, no rope lookups (wavefront fast path; same
        effect as the type-1 branch of _make_edit)."""
        self.subs.append(make_sub_rec(draft_char, best, pos))
        self.contig[pos] = best["sub_base"]

    def _make_edit(self, draft_char, best, st, fh, rh, patch_hash=True):
        """makeEdit (ntedit.cpp:1250-1448).  Returns (fh, rh, edited) where
        ``edited`` is True whenever the sequence content or structure
        changed (substitution/insertion/deletion/rollback/soft-mask).

        ``patch_hash=False`` skips the rolling-hash patching (the wavefront
        engine re-derives window hashes from content and never consumes the
        returned pair)."""
        cfg = self.cfg
        cells = self.cells
        t_idx = st[2]
        kind = best["type"]
        if kind == 1:  # substitution
            cell = cells[t_idx]
            if cell[ORIG] >= 0:
                self.subs.append(make_sub_rec(draft_char, best, st[3]))
                self.contig[cell[ORIG]] = best["sub_base"]
            else:
                cell[CHAR] = best["sub_base"]
            if patch_hash:
                fh = nh.change_last_forward(fh, draft_char, best["sub_base"])
                rh = nh.change_last_reverse(rh, cfg.k, draft_char, best["sub_base"])
            # windows with head past the substituted tail are unedited
            self._dirty_hint = st[3] + 1
            return fh, rh, True
        if kind == 2:  # insertion
            prev = self._prev_insertion(t_idx)
            indel = best["indel"]
            if len(prev) + len(indel) >= cfg.k:
                rollback = is_repeat_insertion(prev) or (
                    len(prev) + len(indel) >= cfg.insertion_cap
                )
                if not rollback:
                    # extend with the new chars one at a time and re-test
                    # (ntedit.cpp:1345-1379); single rollback, clean spec
                    grown = prev
                    for w in range(len(indel)):
                        grown = chr(rc_char(ord(indel[w]))) + grown
                        if is_repeat_insertion(grown):
                            rollback = True
                            break
                if rollback:
                    # tombstone the previous insertion run and re-seed at
                    # the next clean k-mer (ntedit.cpp:1312-1344)
                    run_start = t_idx - len(prev)
                    del cells[run_start:t_idx]
                    st[2] = run_start
                    st[3] = self._seq_of(run_start)
                    kmer = self._find_accepted_kmer(st)
                    if kmer is not None and patch_hash:
                        fh = nh.base_forward_hash(kmer, cfg.k)
                        rh = nh.base_reverse_hash(kmer, cfg.k)
                    self._dirty_hint = st[3] + 2 * cfg.k
                    return fh, rh, True
            new_cells = [[-1, ord(ch), best["support"], 0] for ch in indel]
            cells[t_idx:t_idx] = new_cells
            # cursor now sits on the first inserted char (rope keeps
            # t_node_index pointing at it, ntedit.cpp:625-714)
            if patch_hash:
                fh = nh.change_last_forward(fh, draft_char, ord(indel[0]))
                rh = nh.change_last_reverse(rh, cfg.k, draft_char, ord(indel[0]))
            # inserted cells precede the anchor cell (orig == st[3]); heads
            # from that coordinate on see only original content
            self._dirty_hint = st[3]
            return fh, rh, True
        if kind == 3:  # deletion
            n_del = len(best["indel"])
            if cfg.rope_compat and isinstance(cells, RopeCells):
                # reference node-spanning off-by-one (FIDELITY.md #1)
                n_del = cells.compat_deletion_len(t_idx, n_del)
            del cells[t_idx : t_idx + n_del]
            st[3] = self._seq_of(t_idx)
            if t_idx < len(cells):
                set_span_sup(cells, t_idx, best["support"])
                new_last = self._char_at(t_idx)
            else:
                new_last = 0
            if patch_hash:
                fh = nh.change_last_forward(fh, draft_char, new_last)
                rh = nh.change_last_reverse(rh, cfg.k, draft_char, new_last)
            # post-edit st[3] is the first original coordinate after the
            # junction; windows headed there contain no edited content
            self._dirty_hint = st[3]
            return fh, rh, True
        # kind == 0: no fix (ntedit.cpp:1409-1443)
        edited = False
        if cfg.mask:
            cell = cells[t_idx]
            low = draft_char + 32 if 65 <= draft_char <= 90 else draft_char
            if cell[ORIG] >= 0:
                self.contig[cell[ORIG]] = low
            else:
                cell[CHAR] = low
            if patch_hash:
                fh = nh.change_last_forward(fh, draft_char, low)
                rh = nh.change_last_reverse(rh, cfg.k, draft_char, low)
            self._dirty_hint = st[3] + 1
            edited = True
        if cfg.snv and best["altsupp1"]:
            self.subs.append(
                SubRec(
                    pos=st[3], draft_char=draft_char, sub_base=draft_char,
                    num_support=best["support"],
                    altbase1=best["altbase1"], altsupp1=best["altsupp1"],
                    altbase2=best["altbase2"], altsupp2=best["altsupp2"],
                    altbase3=best["altbase3"], altsupp3=best["altsupp3"],
                )
            )
        return fh, rh, edited

    # -- main scan ---------------------------------------------------------
    def polish_contig(
        self, header: str, seq: bytes, gate_hint: Optional[np.ndarray] = None
    ) -> ContigResult:
        """kmerizeAndCorrect (ntedit.cpp:1747-2151) for one contig.

        ``gate_hint``: optional sorted array of window-head coordinates
        (original draft coordinates) where the absence gate *may* fire —
        produced by the TPU dense pass (ntedit_tpu.engine.flag).  The scan
        fast-forwards across stretches with no hinted gate; the hint must
        have no false negatives for unedited windows (it is exact by
        construction: device probes are bit-identical to host probes).
        Live gates are still re-evaluated, so false positives are harmless.
        After any edit, fast-forwarding is suspended until the scan is 2k
        past the edit (windows overlapping an edit have live state the
        precomputed hint cannot know).
        """
        cfg = self.cfg
        k = cfg.k
        L = len(seq)
        self.contig = bytearray(seq)
        self.cells = [[i, 0, 0, 0] for i in range(L)]
        self.subs = []
        result = ContigResult(header, self.contig, self.cells, self.subs)

        h0 = find_first_accepted_kmer(0, bytes(seq), k)
        st = [h0, h0, h0 + k - 1, h0 + k - 1]  # h_idx, h_seq, t_idx, t_seq
        fh = rh = np.uint64(0)
        if h0 + k - 1 < L:
            kmer = bytes(self.contig[h0 : h0 + k])
            fh = nh.base_forward_hash(kmer, k)
            rh = nh.base_reverse_hash(kmer, k)

        hint_i = 0  # monotone pointer into gate_hint
        dirty_until = 0  # no fast-forward while h_seq < dirty_until
        continue_edit = True
        while continue_edit:
            if st[1] + k - 1 >= L:
                break
            if (
                gate_hint is not None
                and st[1] >= dirty_until
                and st[0] < len(self.cells)
                and self.cells[st[0]][ORIG] == st[1]
            ):
                while hint_i < len(gate_hint) and gate_hint[hint_i] < st[1]:
                    hint_i += 1
                if hint_i >= len(gate_hint):
                    break  # no further gates: rest of the contig is clean
                g = int(gate_hint[hint_i])
                if g > st[1]:
                    delta = g - st[1]
                    st[0] += delta
                    st[2] += delta
                    st[1] = g
                    st[3] = g + k - 1
                    window = bytes(self._char_at(i) for i in range(st[0], st[2] + 1))
                    fh = nh.base_forward_hash(window, k)
                    rh = nh.base_reverse_hash(window, k)
            hv = self._hashes(fh, rh)
            gate = (
                cfg.snv
                or not self.bloom.contains(hv)
                or (self.bloom.is_counting and self.bloom.get_count(hv) < cfg.min_threshold)
            )
            if gate:
                draft_char = _upper(self._char_at(st[2]))
                res = None
                if self.fast:
                    from ntedit_tpu.engine import sitefix

                    res = sitefix.try_fix_site_fast(self, draft_char, st, fh, rh)
                if res is None:
                    res = self._fix_site(draft_char, st, fh, rh)
                fh, rh, edited = res
                if edited:
                    dirty_until = max(dirty_until, self._dirty_hint)
            # bottom roll with non-ACGT skip (ntedit.cpp:2118-2138)
            target = -1
            while True:
                ok, co, ci = self._roll(st)
                if not ok:
                    continue_edit = False
                    break
                if not is_accepted(_upper(ci)):
                    target = st[3] + k
                fh = nh.next_forward_hash(fh, k, co, ci)
                rh = nh.next_reverse_hash(rh, k, co, ci)
                if not (target >= 0 and st[3] != target):
                    break
        return result

    def _fix_site(self, draft_char, st, fh, rh):
        """The flagged-site confirmation + trial block
        (ntedit.cpp:1808-2116).  Returns (fh, rh, edited)."""
        cfg = self.cfg
        k = cfg.k
        tmp = list(st)
        tfh, trh = fh, rh
        check_missing = 0
        check_there = 0
        there_med = []
        do_not_fix = False
        for kk in range(k):
            if tmp[0] >= len(self.cells):
                break
            ok, co, ci = self._roll(tmp)
            if not ok:
                do_not_fix = True
                break
            tfh = nh.next_forward_hash(tfh, k, co, ci)
            trh = nh.next_reverse_hash(trh, k, co, ci)
            if not is_accepted(_upper(ci)):
                do_not_fix = True
                break
            hv = self._hashes(tfh, trh)
            contains = self.bloom.contains(hv)
            if kk % cfg.jump == 0 and not contains:
                check_missing += 1
            elif (
                is_atgc(draft_char)
                and kk % cfg.jump == 0
                and contains
                and (not self.bloom.is_counting or self.bloom.get_count(hv) >= cfg.min_threshold)
            ):
                check_there += 1
                if self.bloom.is_counting:
                    there_med.append(self.bloom.get_count(hv))
        check_there_median = median_u8(there_med) if self.bloom.is_counting else 0
        attempt = cfg.snv or (
            not do_not_fix
            and (
                check_missing >= cfg.missing_needed
                or (self.bloom.is_counting and check_there_median < cfg.min_threshold)
            )
        )
        if not attempt:
            return fh, rh, False

        best = dict(
            type=0, sub_base=0, indel="", alt_indel="", support=0,
            altbase1=0, altsupp1=0, altbase2=0, altsupp2=0, altbase3=0, altsupp3=0,
        )
        del_state = [1]  # num_deletions, shared across alternates (by-ref)
        if cfg.snv and check_there >= cfg.present_needed:
            best["sub_base"] = draft_char
            best["support"] = check_there_median if self.bloom.is_counting else check_there

        for sub_base_ch in self.bases_tab.get(chr(draft_char), ""):
            sub_base = ord(sub_base_ch)
            tfh = nh.change_last_forward(fh, draft_char, sub_base)
            trh = nh.change_last_reverse(rh, k, draft_char, sub_base)
            hv = self._hashes(tfh, trh)
            if (self.bloom.contains(hv) and self._solid(hv)) or cfg.mode == 2:
                # temporarily write the substitution (ntedit.cpp:1936-1940)
                cell = self.cells[st[2]]
                saved = None
                if cell[ORIG] >= 0:
                    saved = self.contig[cell[ORIG]]
                    self.contig[cell[ORIG]] = sub_base
                else:
                    saved = cell[CHAR]
                    cell[CHAR] = sub_base
                tmp = list(st)
                vfh, vrh = tfh, trh
                check_present = 0
                med = []
                for kk in range(k):
                    if tmp[0] >= len(self.cells) or tmp[2] >= len(self.cells):
                        break
                    ok, co, ci = self._roll(tmp)
                    if not ok:
                        break
                    vfh = nh.next_forward_hash(vfh, k, co, ci)
                    vrh = nh.next_reverse_hash(vrh, k, co, ci)
                    hv = self._hashes(vfh, vrh)
                    if kk % cfg.jump == 0 and self.bloom.contains(hv) and self._solid(hv):
                        check_present += 1
                        if self.bloom.is_counting:
                            med.append(self.bloom.get_count(hv))
                # revert (ntedit.cpp:1974-1981)
                if cell[ORIG] >= 0:
                    self.contig[cell[ORIG]] = saved
                else:
                    cell[CHAR] = saved

                if cfg.verbose:
                    self._vtrace("sub", chr(sub_base), check_present, med)
                if check_present >= cfg.present_needed:
                    shuffle_best(best, sub_base, check_present)
                    if cfg.mode in (0, 1):
                        continue
                if cfg.mode == 2 or best["type"] != 1:
                    if self._try_indels(draft_char, sub_base, del_state, st, fh, rh, best):
                        if cfg.mode in (0, 1):
                            break
        return self._make_edit(draft_char, best, st, fh, rh)
