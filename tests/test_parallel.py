"""Mesh parallelism: N-shard BF build == 1-shard build; sharded flag ==
single-device flag; dryrun entry points."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ntedit_tpu.core import bloom
from ntedit_tpu.engine import flag
from ntedit_tpu.parallel import mesh as pmesh
from ntedit_tpu.utils import simulate


K, H, NBITS = 25, 3, 1 << 16


def test_bf_or_merge_equivalence():
    """Data-parallel build across 8 devices == single-shard build."""
    mesh = pmesh.make_mesh(8)
    genome = simulate.random_genome(2100, seed=1)
    rows = np.stack([genome[i * 256 : i * 256 + 256 + K - 1] for i in range(8)])
    merged = np.asarray(pmesh.sharded_bf_build(mesh, rows, K, H, NBITS))
    # single-device reference: insert all rows on one device
    import jax.numpy as jnp
    ref = np.asarray(pmesh.build_bf_words(jnp.asarray(rows), K, H, NBITS))
    np.testing.assert_array_equal(merged, ref)


def test_device_build_matches_host_insert():
    genome = simulate.random_genome(1000, seed=2)
    import jax.numpy as jnp
    words = np.asarray(pmesh.build_bf_words(jnp.asarray(genome[None]), K, H, NBITS))
    host = bloom.KmerBloomFilter.zeros(NBITS // 8, H, K)
    host.insert_seq(genome)
    np.testing.assert_array_equal(words, bloom._pack_words(host.data))


def test_sharded_flag_equals_single():
    genome = simulate.random_genome(4000, seed=3)
    draft = genome.copy()
    draft[1234] = ord("A") if genome[1234] != ord("A") else ord("C")
    host = bloom.KmerBloomFilter.zeros(NBITS // 8, H, K)
    host.insert_seq(genome)
    df = bloom.DeviceFilter.from_host(host)
    want, _, _, _ = flag.flag_contig(draft, df, chunk=512)

    mesh = pmesh.make_mesh(8)
    tiles, n = pmesh.tile_contig(draft, 512, K, n_tiles_multiple=8)
    words = bloom._pack_words(host.data)
    packed = np.asarray(
        pmesh.sharded_flag(mesh, tiles, words, k=K, hash_num=H, nbits=NBITS)
    ).reshape(-1)
    got = np.zeros(n, dtype=bool)
    got[flag.packed_to_positions(packed, n)] = True
    np.testing.assert_array_equal(got, np.asarray(want, dtype=bool))


def test_saturating_add_allreduce():
    from functools import partial
    from ntedit_tpu.parallel.mesh import shard_map
    from jax.sharding import PartitionSpec as P
    import jax.numpy as jnp

    mesh = pmesh.make_mesh(8)
    parts = np.full((8, 64), 40, dtype=np.uint8)

    @partial(shard_map, mesh=mesh, in_specs=P("d"), out_specs=P(), check_vma=False)
    def step(x):
        return pmesh.saturating_add_allreduce(x[0], "d")

    out = np.asarray(jax.jit(step)(parts))
    assert (out == 255).all()  # 8 * 40 = 320 saturates


def test_graft_entry_single():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert int(out[0]) >= 0


def test_graft_entry_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_polish_equals_single():
    """End-to-end 8-shard polish == 1-device polish, byte-identical
    rendered outputs."""
    import io

    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.polish import Polisher
    from ntedit_tpu.io import writers

    def render(result):
        d, r, v = io.StringIO(), io.StringIO(), io.StringIO()
        writers.write_contig(result, d, r, v)
        return d.getvalue() + "\x00" + r.getvalue() + "\x00" + v.getvalue()

    truth = simulate.random_genome(20000, seed=60)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=3e-3, ins_rate=1e-3, del_rate=1e-3, seed=61
    )
    host = bloom.KmerBloomFilter.zeros(NBITS // 8, H, K)
    host.insert_seq(truth)
    words = bloom._pack_words(host.data)
    cfg = EngineConfig(k=K, hash_num=H)

    mesh = pmesh.make_mesh(8)
    sharded = pmesh.sharded_polish(mesh, "ctg", draft, host, words, cfg)

    single = Polisher(host, cfg=cfg, use_device=False)
    single.engine = "sequential"
    ref = single.polish_contig("ctg", draft)

    assert sharded.edited == ref.edited
    assert sharded.subs == ref.subs
    assert render(sharded) == render(ref)


def test_sharded_snv_equals_sequential():
    """SNV through the sharded path (device alternate pre-check hint +
    hinted repair) == the sequential SNV oracle — records and draft
    byte-identical."""
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.oracle import Oracle

    truth = simulate.random_genome(20000, seed=70)
    # SNV input: reference genome vs reads that carry variants — simulate
    # by inserting variant k-mers into the filter alongside the truth's
    variant = truth.copy()
    rng = np.random.default_rng(71)
    for pos in rng.integers(100, len(truth) - 100, size=12):
        variant[pos] = b"ACGT"[int(rng.integers(0, 4))]
    host = bloom.KmerBloomFilter.zeros(NBITS // 8, H, K)
    host.insert_seq(truth)
    host.insert_seq(variant)
    words = bloom._pack_words(host.data)
    cfg = EngineConfig(k=K, hash_num=H, snv=True)

    mesh = pmesh.make_mesh(8)
    sharded = pmesh.sharded_polish(mesh, "ctg", truth, host, words, cfg)
    ref = Oracle(host, None, cfg).polish_contig("ctg", bytes(truth))

    assert sharded.edited == ref.edited
    assert sharded.subs == ref.subs
    assert len(sharded.subs) >= 1  # the variants must surface as records


def test_sharded_polish_mesh_sizes():
    """2-shard == 4-shard == 8-shard polish (merge is mesh-size blind)."""
    truth = simulate.random_genome(12000, seed=62)
    draft, _ = simulate.inject_errors(
        truth, sub_rate=3e-3, ins_rate=1e-3, del_rate=1e-3, seed=63
    )
    host = bloom.KmerBloomFilter.zeros(NBITS // 8, H, K)
    host.insert_seq(truth)
    words = bloom._pack_words(host.data)
    from ntedit_tpu.engine.config import EngineConfig

    cfg = EngineConfig(k=K, hash_num=H)
    outs = []
    for d in (2, 4, 8):
        mesh = pmesh.make_mesh(d)
        res = pmesh.sharded_polish(mesh, "ctg", draft, host, words, cfg)
        outs.append((res.edited, res.subs))
    assert outs[0] == outs[1] == outs[2]


def test_distributed_single_process_identity():
    """Multi-host helpers degrade to identity in a single process; the
    work-slice covers everything exactly once across processes."""
    from ntedit_tpu.parallel import distributed as dist

    dist.initialize()  # no-op single process
    assert dist.process_slice(10) == slice(0, 10)
    recs = [("ctg1", [1, 2]), ("ctg2", [3])]
    assert dist.gather_records(recs) == recs


def test_sharded_polish_blocked_filter_equals_single():
    """Regression (round 4): sharded passes must honor the BLOCKED word
    layout — they silently probed the plain layout before, gating every
    head when given a BlockedKmerBloomFilter (the bench's production
    filter kind)."""
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.polish import Polisher

    wl = simulate.make_workload(length=60_000, k=K, seed=17)
    bbf = bloom.BlockedKmerBloomFilter.zeros(1 << 17, H, K)
    bbf.insert_seq(wl.truth)
    cfg = EngineConfig(k=K, hash_num=H)
    pol = Polisher(bbf, None, cfg)
    want = pol.polish_contig("c", wl.draft)
    mesh = pmesh.make_mesh(8)
    got = pmesh.sharded_polish(
        mesh, "c", wl.draft, bbf, pol.df.words, cfg, chunk=2048)
    assert got.edited == want.edited
    assert got.subs == want.subs


def test_iter_sharded_gate_chunks_matches_single_device():
    """The packed-tile sharded gate stream must report exactly the
    single-device gate set — including exception patching (IUPAC bytes
    force-hinted, unaccepted bytes removed) across group boundaries."""
    from ntedit_tpu.engine.config import EngineConfig

    truth = simulate.random_genome(50000, seed=80)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=81)
    draft = draft.copy()
    draft[5000] = ord("N")          # unaccepted: windows removed
    draft[20000] = ord("R")         # accepted IUPAC: windows force-hinted
    host = bloom.KmerBloomFilter.zeros(NBITS // 8, H, K)
    host.insert_seq(truth)
    df = bloom.DeviceFilter.from_host(host)
    want = flag.flag_contig_gates(draft, df)

    cfg = EngineConfig(k=K, hash_num=H)
    mesh = pmesh.make_mesh(8)
    got = []
    last_frontier = 0
    for frontier, g in pmesh.iter_sharded_gate_chunks(
        mesh, draft, df.words, cfg, nbits=host.bits, cbytes=0,
        blocked=False, counting=False, chunk=1024,
    ):
        assert frontier > last_frontier
        last_frontier = frontier
        got.append(g)
    np.testing.assert_array_equal(np.concatenate(got), want)


def test_sharded_polish_cbf_equals_sequential():
    """Counting filter (coverage band -p) through the sharded pass ==
    the sequential oracle — the CBF mode the round-4 verdict flagged as
    never exercised on the mesh path."""
    from ntedit_tpu.engine.config import EngineConfig
    from ntedit_tpu.engine.oracle import Oracle
    from ntedit_tpu.core import nthash_ref as ref

    truth = simulate.random_genome(20000, seed=90)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=91)
    fh, rh = ref.all_window_hashes(truth, K)
    ext = ref.extend_hashes_vec(ref.canonical(fh, rh), K, H)
    cbf = bloom.KmerCountingBloomFilter8.zeros(1 << 15, H, K)
    for _ in range(5):
        cbf.insert_hashes(ext)
    cfg = EngineConfig(k=K, hash_num=H, min_threshold=3)

    mesh = pmesh.make_mesh(8)
    import jax.numpy as jnp
    sharded = pmesh.sharded_polish(
        mesh, "ctg", draft, cbf, jnp.asarray(cbf.counters), cfg, chunk=2048)
    ref_res = Oracle(cbf, None, cfg).polish_contig("ctg", bytes(draft))
    assert sharded.edited == ref_res.edited
    assert sharded.subs == ref_res.subs
    assert len(sharded.subs) >= 1


@pytest.mark.parametrize("nbits", [1 << 22, 1 << 33])
def test_word_bits_match_host_bit_index(nbits):
    """The mesh build's probe words and bits equal the host btllib layout
    (bit = hash mod nbits) below and past 2^32 bits."""
    from ntedit_tpu.core import nthash_ref as nh

    seq = simulate.random_genome(3000, seed=77)
    widx, bits = pmesh._word_bits(jnp.asarray(seq[None]), K, H, nbits)
    fh, rh = nh.all_window_hashes(seq, K)
    idx = nh.extend_hashes_vec(nh.canonical(fh, rh), K, H) % np.uint64(nbits)
    np.testing.assert_array_equal(
        np.asarray(widx[0]), (idx >> np.uint64(5)).astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(bits[0]),
        (np.uint64(1) << (idx & np.uint64(31))).astype(np.uint32))
