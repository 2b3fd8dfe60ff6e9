"""Device-mesh parallelism: sharded dense scanning and Bloom-filter
collectives.

The reference's only parallelism is OpenMP threads over contigs in shared
memory (/root/reference/ntedit.cpp:2213; SURVEY.md §2.3).  The device
equivalents here are:

* **Contig-window data parallelism** — contigs are tiled into fixed windows
  of ``chunk + k - 1`` bases (k-1-base halo, the genomics analogue of
  sequence/context parallelism: a k-mer straddling a tile boundary needs
  the neighbour's first k-1 bases).  Tiles are sharded across the mesh and
  the dense flag pass runs under shard_map with zero cross-tile
  communication.
* **Bloom-filter OR-allreduce** — data-parallel filter construction builds
  one partial bit array per device from its read shard; the arrays are
  merged with a bitwise-OR allreduce (ring of ppermute+OR over uint32
  words).  The counting-filter analogue is a saturating-add allreduce
  (psum on int32 then clip to uint8).
* **Replicated filter, sharded probes** — during editing the merged filter
  is read-only (ntedit.cpp:2213 shares it across threads); it is
  replicated per device in device memory and probed with device-local
  gathers.

Everything here runs identically on a virtual CPU mesh
(``--xla_force_host_platform_device_count``) and on the GPUs of one host;
on multi-host systems initialize ``jax.distributed`` first and the same
code shards over the global device set.  The mesh is 1-D: every card
reaches every other at the same NVLink rate, so its shape follows the
algorithm alone.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ntedit_tpu.core import bloom, nthash as nt
from ntedit_tpu.engine import flag


def make_mesh(n_devices: Optional[int] = None, axis: str = "d") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def ring_or(x: jnp.ndarray, axis: str) -> jnp.ndarray:
    """Bitwise-OR allreduce across a mesh axis (inside shard_map).

    Implemented as a (D-1)-step ppermute ring: each step every device ORs
    in its left neighbour's rolling buffer.  A reduce-scatter+all-gather
    variant moves fewer bytes per device and is a follow-up
    optimization.
    """
    n = jax.lax.psum(1, axis)
    perm = [(i, (i + 1) % n) for i in range(n)]

    def body(i, carry):
        acc, buf = carry
        buf = jax.lax.ppermute(buf, axis, perm)
        return acc | buf, buf

    acc, _ = jax.lax.fori_loop(0, n - 1, body, (x, x))
    return acc


def saturating_add_allreduce(counts_u8: jnp.ndarray, axis: str) -> jnp.ndarray:
    """CBF merge: sum per-device uint8 counters with saturation at 255."""
    s = jax.lax.psum(counts_u8.astype(jnp.int32), axis)
    return jnp.minimum(s, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Data-parallel BF construction (device-side insert + OR merge)
# ---------------------------------------------------------------------------

def _word_bits(seqs, k: int, hash_num: int, nbits_pow2: int):
    """Probe words and bits of every window of every row of ``seqs``
    [R, Lr] -> (uint32 word index, uint32 single-bit mask), each
    [R, Lr-k+1, hash_num].  Power-of-two filters only (framework-native
    sizing) so the modulo is a mask; the bit index is ``hash mod nbits``
    over the hash's low and high words, as in the btllib layout
    (bfbuild.DeviceFilterBuilder's plain layout)."""
    assert nbits_pow2 & (nbits_pow2 - 1) == 0 and nbits_pow2 <= (1 << 36)
    lo_mask = np.uint32(min(nbits_pow2, 1 << 32) - 1)
    hi_mask = np.uint32(max(nbits_pow2 >> 32, 1) - 1)

    def per_row(row):
        fh, rh = nt.window_hashes(row, k)
        hashes = nt.extend(nt.canonical(fh, rh), k, hash_num)
        widx = [((h[0] & hi_mask) << np.uint32(27))
                | ((h[1] & lo_mask) >> np.uint32(5)) for h in hashes]
        bits = [jnp.uint32(1) << (h[1] & np.uint32(31)) for h in hashes]
        return jnp.stack(widx, -1), jnp.stack(bits, -1)

    return jax.vmap(per_row)(seqs)


def build_bf_words(seqs, k: int, hash_num: int, nbits_pow2: int) -> jnp.ndarray:
    """Device-local BF build: insert every k-mer of every row.

    Returns the packed uint32 word array [nbits/32], built with the exact
    sort-based scatter-OR (bfbuild.scatter_or_words) — no byte-per-bit
    transient, so per-device partial filters scale to device memory."""
    from ntedit_tpu.core.bfbuild import scatter_or_words

    widx, bits = _word_bits(seqs, k, hash_num, nbits_pow2)
    words = jnp.zeros((nbits_pow2 // 32,), jnp.uint32)
    return scatter_or_words(words, widx.reshape(-1), bits.reshape(-1))


def sharded_bf_build(mesh: Mesh, read_shards: np.ndarray, k: int, hash_num: int,
                     nbits_pow2: int) -> jnp.ndarray:
    """Data-parallel BF construction: shard reads over the mesh, build
    per-device partial filters, merge with the OR-allreduce.  Returns the
    replicated word array."""

    @partial(
        shard_map, mesh=mesh,
        in_specs=P("d"), out_specs=P(),
        check_vma=False,
    )
    def step(shard):
        words = build_bf_words(shard, k, hash_num, nbits_pow2)
        return ring_or(words, "d")

    return jax.jit(step)(read_shards)


def build_cbf_counts(seqs, k: int, hash_num: int, nslots_pow2: int) -> jnp.ndarray:
    """Device-local counting-filter build: saturating 8-bit counters over
    every k-mer of every row (btllib KmerCountingBloomFilter8 semantics:
    all hash_num slots +1 per insert, saturate at 255)."""
    mask = np.uint32(nslots_pow2 - 1)
    assert nslots_pow2 & (nslots_pow2 - 1) == 0

    def per_row(row):
        fh, rh = nt.window_hashes(row, k)
        hashes = nt.extend(nt.canonical(fh, rh), k, hash_num)
        return jnp.stack([(h[1] & mask).astype(jnp.int32) for h in hashes], -1)

    idx = jax.vmap(per_row)(seqs).reshape(-1)
    counts = jnp.zeros((nslots_pow2,), jnp.int32).at[idx].add(1)
    return jnp.minimum(counts, 255).astype(jnp.uint8)


def sharded_cbf_build(mesh: Mesh, read_shards: np.ndarray, k: int,
                      hash_num: int, nslots_pow2: int) -> jnp.ndarray:
    """Data-parallel counting-filter construction: per-device partial
    counters merged with the saturating-add allreduce."""

    @partial(
        shard_map, mesh=mesh,
        in_specs=P("d"), out_specs=P(),
        check_vma=False,
    )
    def step(shard):
        counts = build_cbf_counts(shard, k, hash_num, nslots_pow2)
        return saturating_add_allreduce(counts, "d")

    return jax.jit(step)(read_shards)


# ---------------------------------------------------------------------------
# Sharded dense flag pass
# ---------------------------------------------------------------------------

def _row_batch(width: int) -> int:
    """lax.map batch size for per-tile passes: cap the live per-batch
    transient (~tens of u32 vectors per base) so wide production tiles
    (2^20+ bases, bench/large runs) stay inside device memory while narrow test
    tiles still vectorize across rows."""
    return max(1, (1 << 22) // max(1, width))


def sharded_flag(mesh: Mesh, tiles: np.ndarray, words: jnp.ndarray, *, k: int,
                 hash_num: int, nbits: int, snv: bool = False,
                 min_threshold: int = 1, blocked: bool = False):
    """tiles: [T, chunk + k - 1] uint8, T divisible by mesh size; filter
    words replicated.  Returns the PACKED gate bitmap uint32 [T, chunk/32]
    on host (32x less readback than bools; unpack with
    flag.packed_to_positions on the flattened words)."""
    bs = _row_batch(tiles.shape[1])

    def per_tile(tile, w):
        df = bloom.DeviceFilter(w, None, nbits, 0, hash_num, k, False,
                                   blocked=blocked)
        gate, _p, _c, _v = flag.flag_chunk(tile, df, k, snv, min_threshold)
        lanes = jnp.arange(32, dtype=jnp.uint32)
        b = gate.reshape(-1, 32).astype(jnp.uint32)
        return (b << lanes[None, :]).sum(axis=1, dtype=jnp.uint32)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P("d", None), P()), out_specs=P("d", None),
        check_vma=False,
    )
    def step(tile_shard, w):
        return jax.lax.map(lambda t: per_tile(t, w), tile_shard, batch_size=bs)

    return jax.jit(step)(tiles, words)


def sharded_snv_candidates(mesh: Mesh, tiles: np.ndarray, words: jnp.ndarray,
                           *, k: int, hash_num: int, nbits: int,
                           blocked: bool = False):
    """Sharded SNV candidate pass: the device alternate pre-check
    (engine.flag.snv_candidates_chunk — changelast rehash of all four
    bases, ntedit.cpp:434-452/1923-1928) over contig tiles sharded across
    the mesh.  tiles: [T, chunk + k - 1] uint8 with k-1 halos, T divisible
    by mesh size; filter words replicated.  Returns candidate bitmap
    words [T, chunk/32] on host — positions with no passing alternate are
    provably no-ops, so the unpacked set is an exact repair hint under
    the same eligibility as Polisher._snv_fast_eligible."""

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P("d", None), P()), out_specs=P("d", None),
        check_vma=False,
    )
    def step(tile_shard, w):
        df = bloom.DeviceFilter(w, None, nbits, 0, hash_num, k, False,
                                   blocked=blocked)
        return jax.lax.map(lambda t: flag.snv_candidates_chunk(t, df, k),
                           tile_shard, batch_size=_row_batch(tiles.shape[1]))

    return jax.jit(step)(tiles, words)


def sharded_polish_cand_planes(mesh: Mesh, tiles: np.ndarray,
                               words: jnp.ndarray, *, k: int, hash_num: int,
                               nbits: int, blocked: bool = False):
    """Sharded polish substitution-candidate pass: the
    per-base changelast presence planes (flag.polish_cand_planes_chunk;
    ntedit.cpp:1923-1928's first-level probe) over contig tiles sharded
    across the mesh.  Returns [T, 5, chunk/32] plane words on host —
    planes 0-3 per-base presence, plane 4 validity.  N chips divide the
    one extra dense pass; the host repair then probes only surviving
    (site, base) pairs."""

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P("d", None), P()), out_specs=P("d", None, None),
        check_vma=False,
    )
    def step(tile_shard, w):
        df = bloom.DeviceFilter(w, None, nbits, 0, hash_num, k, False,
                                   blocked=blocked)
        return jax.lax.map(
            lambda t: flag.polish_cand_planes_chunk(t, df, k),
            tile_shard, batch_size=_row_batch(tiles.shape[1]),
        )

    return jax.jit(step)(tiles, words)


def sharded_confirm(mesh: Mesh, W: np.ndarray, words: jnp.ndarray, *, k: int,
                    jump: int, hash_num: int, nbits: int,
                    blocked: bool = False):
    """Sharded flagged-site confirmation: the subset-missing scan
    (ntedit.cpp:1820-1873) batched over candidate sites and sharded across
    the mesh — the repair pass's verify compute as a mesh collective-free
    data-parallel stage.

    W: [S, 2k] site windows (S divisible by mesh size), filter words
    replicated.  Returns (check_missing [S], gate [S]) on host.
    """
    stride = np.arange(k) % jump == 0

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P("d", None), P()), out_specs=(P("d"), P("d")),
        check_vma=False,
    )
    def step(rows, w):
        df = bloom.DeviceFilter(w, None, nbits, 0, hash_num, k, False,
                                   blocked=blocked)

        def per_row(row):
            fh, rh = nt.window_hashes(row, k)
            hashes = nt.extend(nt.canonical(fh, rh), k, df.hash_num)
            present = df.contains(hashes)
            gate = ~present[0]
            miss = (~present[1 : k + 1]) & jnp.asarray(stride)
            return miss.sum(dtype=jnp.int32), gate

        return jax.lax.map(per_row, rows, batch_size=_row_batch(W.shape[1]))

    return jax.jit(step)(W, words)


# ---------------------------------------------------------------------------
# Packed-tile sharded dense pass (the production sharded driver)
#
# The ASCII tile path above uploads chunk+k-1 BYTES per tile.  This path
# tiles the 2-bit PACKED code words instead (same encoding as the
# single-device engine.flag packed driver, 4x less host->device traffic)
# and dispatches tile GROUPS asynchronously so gate readback —
# and the host segment repair consuming it — overlaps the dense compute
# of later groups (the sharded analogue of flag.iter_gate_chunks).
# Exception windows (non-ACGT bytes) are patched host-side per
# isAcceptedBase semantics exactly like the single-chip path.
# ---------------------------------------------------------------------------

def _tile_packed(seq: np.ndarray, chunk: int, k: int, group: int):
    """Packed-word tiling: [T, chunk/16 + halo_words] uint32 rows, T padded
    to a multiple of ``group``.  chunk must be a multiple of 32."""
    assert chunk % 32 == 0
    n = len(seq) - k + 1
    packed_np, exc = flag._encode_packed(seq, n, k, chunk)
    wpt = chunk // 16
    W = wpt + flag._halo_words(k)
    T = -(-max(1, -(-n // chunk)) // group) * group
    need = T * wpt + flag._halo_words(k)
    if len(packed_np) < need:
        packed_np = np.concatenate(
            [packed_np, np.zeros(need - len(packed_np), np.uint32)])
    from numpy.lib.stride_tricks import as_strided

    tiles = as_strided(packed_np, shape=(T, W), strides=(wpt * 4, 4))
    return tiles, n, exc


from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=32)
def _gate_group_fn(mesh: Mesh, k: int, hash_num: int, nbits: int,
                   cbytes: int, snv: bool, min_threshold: int,
                   blocked: bool, counting: bool, chunk: int, bs: int):
    """Compiled sharded gate program over one packed tile group:
    (tiles [G, W] uint32, filter array replicated) -> gate words
    [G, chunk/32].  Cached so every group (and every later contig of the
    same shape) reuses one executable."""

    def per_tile(wrow, arr):
        if counting:
            df = bloom.DeviceFilter(None, arr, 0, cbytes, hash_num, k, True)
        else:
            df = bloom.DeviceFilter(arr, None, nbits, 0, hash_num, k, False,
                                    blocked=blocked)
        shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, :]
        codes = ((wrow[:, None] >> shifts) & jnp.uint32(3)).astype(jnp.uint8)
        seqc = codes.reshape(-1)[: chunk + k - 1]
        fh, rh = nt.window_hashes_codes(seqc, k)
        can = nt.canonical(fh, rh)
        hashes = [can] if (blocked and not counting) else nt.extend(
            can, k, hash_num)
        if counting:
            count = df.count(hashes)
            present = count > 0
        else:
            present = df.contains(hashes)
        gate = jnp.full(chunk, snv) | ~present
        if counting and min_threshold > 1:
            gate = gate | (count < np.uint8(min_threshold))
        lanes = jnp.arange(32, dtype=jnp.uint32)
        b = gate.reshape(-1, 32).astype(jnp.uint32)
        return (b << lanes[None, :]).sum(axis=1, dtype=jnp.uint32)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P("d", None), P()), out_specs=P("d", None),
        check_vma=False,
    )
    def step(tile_shard, arr):
        return jax.lax.map(lambda t: per_tile(t, arr), tile_shard,
                           batch_size=bs)

    return jax.jit(step)


def _auto_chunk(n: int, D: int, chunk) -> int:
    """Tile width: honor an explicit ``chunk``; otherwise largest pow2 in
    [2^15, 2^21] that still gives every device >= 2 tiles."""
    if chunk is not None:
        return chunk
    c = 1 << 21
    while c > (1 << 15) and n < 2 * D * c:
        c >>= 1
    return c


def iter_sharded_gate_chunks(
    mesh: Mesh, draft: np.ndarray, filter_arr: jnp.ndarray, cfg, *,
    nbits: int, cbytes: int, blocked: bool, counting: bool,
    chunk: Optional[int] = None, snv: Optional[bool] = None,
):
    """Stream gate positions for one contig through the sharded dense
    pass: yields (frontier, abs_gates) with every head < frontier final —
    the sharded analogue of flag.iter_gate_chunks.  All tile groups are
    dispatched up front (async); readbacks drain in order so consumers
    overlap host repair with in-flight device compute."""
    k = cfg.k
    D = mesh.devices.size
    n = len(draft) - k + 1
    if n <= 0:
        return
    snv = cfg.snv if snv is None else snv
    chunk = _auto_chunk(n, D, chunk)
    # group = one dispatch: D * gpt tiles, sized ~2^22 heads per dispatch
    gpt = max(2, (1 << 22) // (chunk * D))
    group = D * gpt
    tiles, n, exc = _tile_packed(draft, chunk, k, group)
    iupac_heads, bad_heads = flag._exception_hints(draft, exc, n, k)
    bs = max(1, (1 << 22) // chunk)
    # replicate the filter onto THIS mesh (an array committed to a
    # different submesh — e.g. built on the full mesh, polished on N=3 —
    # would fail shard_map's device check; a matching placement is a no-op)
    filter_arr = jax.device_put(filter_arr, NamedSharding(mesh, P()))
    fn = _gate_group_fn(mesh, k, cfg.hash_num, nbits, cbytes, bool(snv),
                        cfg.min_threshold, blocked, counting, chunk, bs)
    outs = []
    for g in range(tiles.shape[0] // group):
        gt = jnp.asarray(np.ascontiguousarray(tiles[g * group : (g + 1) * group]))
        out = fn(gt, filter_arr)
        try:
            out.copy_to_host_async()
        except AttributeError:
            pass
        outs.append(out)
    heads_per_group = group * chunk
    for g, out in enumerate(outs):
        start = g * heads_per_group
        end = min(start + heads_per_group, n)
        if start >= n:
            break
        words = np.asarray(out).reshape(-1)
        gates = flag.packed_to_positions(words, end - start) + start
        if bad_heads.size:
            lo, hi = np.searchsorted(bad_heads, (start, end))
            gates = np.setdiff1d(gates, bad_heads[lo:hi], assume_unique=True)
        if iupac_heads.size:
            lo, hi = np.searchsorted(iupac_heads, (start, end))
            gates = flag._merge_heads(gates, iupac_heads[lo:hi])
        yield end, gates


def sharded_polish(
    mesh: Mesh,
    header: str,
    draft: np.ndarray,
    host_bf,
    words: jnp.ndarray,
    cfg,
    chunk: Optional[int] = None,
    threads: Optional[int] = None,
    host_bloomrep=None,
):
    """End-to-end sharded polish of one contig.

    1. The contig is 2-bit packed ONCE and tiled into k-1-halo packed-word
       windows sharded over the mesh; the dense flag pass runs per shard
       against the replicated filter (zero cross-shard communication —
       SURVEY §5.7 halo design), tile groups dispatched asynchronously.
    2. Gate heads stream back group by group (the record-gather point; on
       multi-host meshes this is a process-local slice + allgather).
    3. Repair of closed segments starts WHILE later groups still compute
       (native_repair.polish_contig_pipelined — the pipelined single-chip
       engine fed by the sharded stream); per-segment edit records are
       merged with coordinate offsets into one ContigResult (the record
       merge point the path replaces: ntedit.cpp:2145-2150).

    ``words``: the replicated filter array — packed words for presence
    filters (blocked or plain layout, matched to ``host_bf``), the uint8
    counter array for counting filters.

    NTEDIT_TPU_CAND=1 opts into the barrier route with the device
    substitution-candidate planes (one extra dense pass; pays off when
    host repair, not the dense pass, is the wall).

    Output is byte-identical to the single-device polish
    (tests/test_parallel.py::test_sharded_polish_equals_single).
    """
    from ntedit_tpu.engine import native_repair
    from ntedit_tpu.engine.oracle import Oracle

    import os

    k = cfg.k
    D = mesh.devices.size
    # the replicated array may be blocked-layout words, plain btllib
    # words, or CBF counters — probes must match the host filter bit-level
    blocked = bool(getattr(host_bf, "blocked_layout", False))
    counting = hasattr(host_bf, "counters")
    nbits = 0 if counting else host_bf.bits
    cbytes = host_bf.bytes if counting else 0
    if threads is None:
        # repair threads run on THIS host: size by its cores, not the mesh
        # (an 8-device mesh on a 2-core host would oversubscribe 4x)
        threads = max(2, min(os.cpu_count() or 2, D))
    res = None
    if cfg.snv:
        # SNV at scale: the device alternate pre-check is an exact hint
        # under the same eligibility as Polisher._snv_fast_eligible
        # (plain filter, no reject BF, mode != 2, mask off) — the
        # reference's marquee large-scale mode (README.md:48-49) through
        # the sharded pass (ntedit.cpp:1890-1914, 2411-2420)
        eligible = (not counting and cfg.mode != 2 and not cfg.mask
                    and host_bloomrep is None)
        if eligible:
            tiles, n_heads = tile_contig(draft, chunk or 512, k,
                                         n_tiles_multiple=D)
            cw = sharded_snv_candidates(
                mesh, tiles, words, k=k, hash_num=cfg.hash_num,
                nbits=host_bf.bits, blocked=blocked,
            )
            cand_all = flag.packed_to_positions(
                np.asarray(cw).reshape(-1), n_heads
            )
            res = native_repair.polish_contig_segmented(
                host_bf, None, cfg, header, bytes(draft), cand_all,
                threads=threads, allow_snv=True,
            )
            if res is None:
                res = native_repair.polish_contig_native(
                    host_bf, None, cfg, header,
                    np.frombuffer(bytes(draft), np.uint8),
                    gate_hint=cand_all,
                )
        elif cfg.snv:
            # ineligible SNV configs (CBF band, reject BF, mode 2, mask):
            # exact sequential path on the full head set
            res = Oracle(host_bf, host_bloomrep, cfg).polish_contig(
                header, bytes(draft))
        if res is not None:
            return res

    use_cand = (
        os.environ.get("NTEDIT_TPU_CAND") == "1"
        and not cfg.snv and not counting and cfg.mode != 2
        and host_bloomrep is None
        and native_repair.available()
    )
    if not cfg.snv and not use_cand and native_repair.available():
        # production route: pipelined — repair closed segments while
        # later tile groups still compute on the mesh
        stream = iter_sharded_gate_chunks(
            mesh, draft, words, cfg, nbits=nbits, cbytes=cbytes,
            blocked=blocked, counting=counting, chunk=chunk,
        )
        streamed: list = []
        res = native_repair.polish_contig_pipelined(
            host_bf, host_bloomrep, cfg, header, draft, stream,
            threads=threads, collect_gates=streamed,
        )
        if res is not None:
            return res
        gates = (np.concatenate(streamed) if streamed
                 else np.zeros(0, dtype=np.int64))
    else:
        # barrier route (cand planes / fallbacks): full dense pass first
        chunks = list(iter_sharded_gate_chunks(
            mesh, draft, words, cfg, nbits=nbits, cbytes=cbytes,
            blocked=blocked, counting=counting, chunk=chunk,
        ))
        gates = (np.concatenate([g for _f, g in chunks]) if chunks
                 else np.zeros(0, dtype=np.int64))
    res = None
    if not cfg.snv:
        cand = None
        if use_cand and len(gates):
            # device pre-verification of substitution candidates: the
            # sharded changelast pass rides ASCII tiles; host trials then
            # touch only surviving (site, base) pairs
            tiles, n_heads = tile_contig(draft, chunk or 512, k,
                                         n_tiles_multiple=D)
            pw = np.asarray(sharded_polish_cand_planes(
                mesh, tiles, words, k=k, hash_num=cfg.hash_num,
                nbits=host_bf.bits, blocked=blocked,
            ))
            planes = pw.transpose(1, 0, 2).reshape(5, -1)
            cand = flag.cand_masks_from_planes(planes, gates)
        res = native_repair.polish_contig_segmented(
            host_bf, host_bloomrep, cfg, header, bytes(draft), gates,
            threads=threads, gate_cand=cand,
        )
    if res is None:  # native lib unavailable or SNV: exact sequential path
        res = Oracle(host_bf, host_bloomrep, cfg).polish_contig(
            header, bytes(draft), gate_hint=gates
        )
    return res


def tile_contig(seq: np.ndarray, chunk: int, k: int, n_tiles_multiple: int = 1):
    """Tile one contig into [T, chunk + k - 1] windows with k-1 halos,
    padding the tail (and T up to a multiple) with zero bytes.  Returns
    (tiles, n_heads) where n_heads = len(seq) - k + 1 valid head count."""
    L = len(seq)
    n = max(0, L - k + 1)
    T = max(1, -(-n // chunk))
    T = -(-T // n_tiles_multiple) * n_tiles_multiple
    padded = np.zeros(T * chunk + k - 1, dtype=np.uint8)
    padded[:L] = seq
    tiles = np.stack([padded[i * chunk : i * chunk + chunk + k - 1] for i in range(T)])
    return tiles, n
