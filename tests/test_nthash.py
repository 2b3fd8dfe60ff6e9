"""ntHash2 correctness: algebraic invariants of the NumPy spec, and
bit-identity of the JAX device implementation against the spec.

The reference engine relies on these exact identities
(/root/reference/ntedit.cpp:403-452); with btllib unavailable in this
environment the invariants + recorded vectors below pin the semantics.
"""

import numpy as np
import pytest

from ntedit_tpu.core import nthash_ref as ref

RNG = np.random.default_rng(0xBEEF)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def rand_seq(n):
    return BASES[RNG.integers(0, 4, size=n)]


def revcomp(seq):
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    return comp[seq][::-1]


class TestSrol:
    def test_srol1_bijective_period(self):
        x = np.uint64(0x0123456789ABCDEF)
        y = x
        seen = set()
        for _ in range(ref.SROL_PERIOD):
            y = ref.srol1(y)
            seen.add(int(y))
        assert y == x  # period divides 1023
        assert len(seen) > 1

    def test_srol_d_matches_iterated(self):
        xs = RNG.integers(0, 1 << 64, size=50, dtype=np.uint64)
        for x in xs:
            y = x
            for d in range(1, 70):
                y = ref.srol1(y)
                assert ref.srol(x, d) == y, d

    def test_sror1_inverse(self):
        xs = RNG.integers(0, 1 << 64, size=100, dtype=np.uint64)
        for x in xs:
            assert ref.sror1(ref.srol1(x)) == x

    def test_split_independence(self):
        # low 33 bits and high 31 bits never mix
        lo_only = np.uint64((1 << 33) - 1)
        hi_only = np.uint64(~((1 << 33) - 1) & ((1 << 64) - 1))
        for d in range(1, 40):
            assert ref.srol(lo_only, d) == lo_only
            assert ref.srol(hi_only, d) == hi_only


class TestHashAlgebra:
    @pytest.mark.parametrize("k", [4, 25, 33, 55, 64])
    def test_roll_matches_scratch(self, k):
        seq = rand_seq(k + 40)
        fh = ref.base_forward_hash(seq[:k], k)
        rh = ref.base_reverse_hash(seq[:k], k)
        for i in range(1, 40):
            fh = ref.next_forward_hash(fh, k, seq[i - 1], seq[i + k - 1])
            rh = ref.next_reverse_hash(rh, k, seq[i - 1], seq[i + k - 1])
            assert fh == ref.base_forward_hash(seq[i : i + k], k), i
            assert rh == ref.base_reverse_hash(seq[i : i + k], k), i

    @pytest.mark.parametrize("k", [5, 25, 54])
    def test_reverse_is_forward_of_revcomp(self, k):
        for _ in range(20):
            s = rand_seq(k)
            assert ref.base_reverse_hash(s, k) == ref.base_forward_hash(revcomp(s), k)

    @pytest.mark.parametrize("k", [25, 31])
    def test_canonical_strand_invariant(self, k):
        for _ in range(20):
            s = rand_seq(k)
            f1, r1, h1 = ref.ntmc64(s, k, 4)
            f2, r2, h2 = ref.ntmc64(revcomp(s), k, 4)
            assert ref.canonical(f1, r1) == ref.canonical(f2, r2)
            np.testing.assert_array_equal(h1, h2)

    @pytest.mark.parametrize("k", [25])
    def test_change_last(self, k):
        """NTMC64_changelast identity (ntedit.cpp:434-452): replacing the
        final window base == hashing the modified window from scratch."""
        for _ in range(30):
            s = rand_seq(k)
            for new in BASES:
                fh = ref.base_forward_hash(s, k)
                rh = ref.base_reverse_hash(s, k)
                fh2 = ref.change_last_forward(fh, s[k - 1], new)
                rh2 = ref.change_last_reverse(rh, k, s[k - 1], new)
                s2 = s.copy()
                s2[k - 1] = new
                assert fh2 == ref.base_forward_hash(s2, k)
                assert rh2 == ref.base_reverse_hash(s2, k)

    def test_lowercase_equivalence(self):
        s = b"acgtACGTacgtACGTacgtACGTa"
        assert ref.base_forward_hash(s, 25) == ref.base_forward_hash(s.upper(), 25)
        assert ref.base_reverse_hash(s, 25) == ref.base_reverse_hash(s.upper(), 25)

    def test_non_acgt_seeds_zero_forward(self):
        assert ref.seed(ord("N")) == 0
        assert ref.seed(ord("R")) == 0
        # complement aliasing quirk inherited from the CP_OFF trick:
        assert ref.cseed(ord("A")) == ref.SEED_T
        assert ref.cseed(ord("Y")) == ref.SEED_T  # 'Y'&7 == 'A'&7

    @pytest.mark.parametrize("k", [25, 55])
    def test_all_window_hashes_vectorized(self, k):
        seq = rand_seq(500)
        fh, rh = ref.all_window_hashes(seq, k)
        for h in range(0, len(seq) - k + 1, 17):
            assert fh[h] == ref.base_forward_hash(seq[h : h + k], k)
            assert rh[h] == ref.base_reverse_hash(seq[h : h + k], k)

    def test_recorded_vectors(self):
        """Known-answer vectors recorded from this implementation; any
        change to constants or algebra must be deliberate."""
        fh = ref.base_forward_hash(b"ACGTACGTACGTACGTACGTACGTA", 25)
        rh = ref.base_reverse_hash(b"ACGTACGTACGTACGTACGTACGTA", 25)
        h = ref.extend_hashes(ref.canonical(fh, rh), 25, 3)
        # record-once values (stability tripwire)
        assert isinstance(int(fh), int) and isinstance(int(rh), int)
        vec = (int(fh), int(rh), int(h[1]), int(h[2]))
        assert vec == (
            10785916413125401559,
            2360156280656789235,
            9814148822600448985,
            2733679892149082421,
        )


class TestJaxParity:
    """JAX u32-pair implementation == NumPy u64 spec."""

    def setup_method(self):
        from ntedit_tpu.core import nthash as nt
        from ntedit_tpu.utils import u64 as u
        self.nt, self.u = nt, u

    def test_srol_var_parity(self):
        xs = RNG.integers(0, 1 << 64, size=256, dtype=np.uint64)
        ds = RNG.integers(0, 3000, size=256)
        want = ref.srol_vec(xs, ds % ref.SROL_PERIOD)
        got = self.u.to_np(self.u.srol_var(self.u.from_np(xs), ds.astype(np.int32)))
        np.testing.assert_array_equal(got, want)

    def test_srol_const_parity(self):
        xs = RNG.integers(0, 1 << 64, size=64, dtype=np.uint64)
        for d in [0, 1, 24, 32, 33, 62, 1022]:
            want = ref.srol_vec(xs, np.full(64, d))
            got = self.u.to_np(self.u.srol_const(self.u.from_np(xs), d))
            np.testing.assert_array_equal(got, want, err_msg=f"d={d}")

    def test_mul_parity(self):
        a = RNG.integers(0, 1 << 64, size=200, dtype=np.uint64)
        b = RNG.integers(0, 1 << 64, size=200, dtype=np.uint64)
        lo = self.u.to_np(self.u.mul_lo(self.u.from_np(a), self.u.from_np(b)))
        np.testing.assert_array_equal(lo, a * b)  # numpy wraps mod 2^64
        hi, lo2 = self.u.mul_full(self.u.from_np(a), self.u.from_np(b))
        full = [(int(x) * int(y)) for x, y in zip(a, b)]
        np.testing.assert_array_equal(self.u.to_np(hi), np.array([f >> 64 for f in full], dtype=np.uint64))
        np.testing.assert_array_equal(self.u.to_np(lo2), np.array([f & ((1 << 64) - 1) for f in full], dtype=np.uint64))

    def test_mod_divisor(self):
        ns = RNG.integers(0, 1 << 64, size=300, dtype=np.uint64)
        for d in [3, 8, 25 * 8, 137438953447, (1 << 33) - 9, 11488448 * 12, 1 << 37, 0xFFFFFFFFFF]:
            div = self.u.make_divisor(d)
            got = self.u.to_np(self.u.mod_divisor(self.u.from_np(ns), div))
            np.testing.assert_array_equal(got, ns % np.uint64(d), err_msg=f"d={d}")

    @pytest.mark.parametrize("k", [25, 55])
    def test_window_hashes_parity(self, k):
        seq = rand_seq(400)
        # sprinkle non-ACGT
        seq[50] = ord("N")
        seq[200] = ord("R")
        want_f, want_r = ref.all_window_hashes(seq, k)
        import jax.numpy as jnp
        fh, rh = self.nt.window_hashes(jnp.asarray(seq), k)
        np.testing.assert_array_equal(self.u.to_np(fh), want_f)
        np.testing.assert_array_equal(self.u.to_np(rh), want_r)

    @pytest.mark.parametrize("k", [25])
    def test_extend_parity(self, k):
        seq = rand_seq(100)
        fh, rh = ref.all_window_hashes(seq, k)
        base = ref.canonical(fh, rh)
        want = ref.extend_hashes_vec(base, k, 4)
        import jax.numpy as jnp
        jfh, jrh = self.nt.window_hashes(jnp.asarray(seq), k)
        got = self.nt.extend(self.nt.canonical(jfh, jrh), k, 4)
        for i in range(4):
            np.testing.assert_array_equal(self.u.to_np(got[i]), want[:, i])

    @pytest.mark.parametrize("k", [25, 33])
    def test_windows_direct_parity(self, k):
        seq = rand_seq(300)
        starts = np.arange(0, 300 - k + 1, 7, dtype=np.int32)
        import jax.numpy as jnp
        frot, rrot, _ = self.nt.rotated_seed_tables(k)
        fh, rh = self.nt.windows_direct(jnp.asarray(seq), k, jnp.asarray(starts), frot, rrot)
        want_f, want_r = ref.all_window_hashes(seq, k)
        np.testing.assert_array_equal(self.u.to_np(fh), want_f[starts])
        np.testing.assert_array_equal(self.u.to_np(rh), want_r[starts])


def test_canonical_rc_invariance_bulk():
    """hash(kmer) == hash(revcomp(kmer)) for every window — the defining
    external property of canonical ntHash (verifiable without btllib
    artifacts; complements the published-constant pinning above)."""
    from ntedit_tpu.utils import simulate

    seq = simulate.random_genome(3000, seed=77)
    k = 25
    fh, rh = ref.all_window_hashes(seq, k)
    can = ref.canonical(fh, rh)
    rc_map = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        rc_map[a] = b
    rc = rc_map[seq][::-1].copy()
    fh2, rh2 = ref.all_window_hashes(rc, k)
    can2 = ref.canonical(fh2, rh2)[::-1]
    np.testing.assert_array_equal(can, can2)


def test_published_seed_constants():
    """The per-base seeds and NTM64 mixing constants are the published
    ntHash values (the only offline-verifiable external anchor; FIDELITY
    #9 documents why byte-level btllib artifacts are unavailable here)."""
    assert ref.SEED_TAB[ord("A")] == np.uint64(0x3C8BFBB395C60474)
    assert ref.SEED_TAB[ord("C")] == np.uint64(0x3193C18562A02B4C)
    assert ref.SEED_TAB[ord("G")] == np.uint64(0x20323ED082572324)
    assert ref.SEED_TAB[ord("T")] == np.uint64(0x295549F54BE24456)
    assert ref.MULTISEED == np.uint64(0x90B45D39FB6DA1FA)
    assert int(ref.MULTISHIFT) == 27
