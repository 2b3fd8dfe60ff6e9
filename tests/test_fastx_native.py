"""Native batch reader == pure-Python reader (when the library is built)."""

import gzip
import os

import numpy as np
import pytest

from ntedit_tpu.io import fastx, native


def _write_corpus(tmp_path):
    fa = tmp_path / "x.fa"
    fa.write_text(
        ">c1 first contig\nACGTacgtNNRY\nGGTTAA\n"
        ">c2\nAAAA\n"
        ">c3 tab\tsep comment\nCCGG\n"
    )
    fq = tmp_path / "y.fq.gz"
    body = b"@r1 lane1\nACGTACGT\n+\nFFFFFFFF\n@r2\nGGGG\n+junk\n!!!!\n"
    with gzip.open(fq, "wb") as f:
        f.write(body)
    return str(fa), str(fq)


@pytest.mark.skipif(native.get_lib() is None, reason="libntpu_io.so not built")
def test_native_matches_python(tmp_path):
    fa, fq = _write_corpus(tmp_path)
    for path in (fa, fq):
        os.environ["NTEDIT_TPU_NATIVE_IO"] = "1"
        got = list(fastx.read_fastx(path))
        # force pure-python reference
        ref = list(fastx._read_fasta(fastx._open_text_stream(path))) \
            if path.endswith(".fa") else \
            list(fastx._read_fastq(fastx._open_text_stream(path)))
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.name == r.name
            assert g.comment == r.comment
            assert bytes(g.seq) == bytes(r.seq)


@pytest.mark.skipif(native.get_lib() is None, reason="libntpu_io.so not built")
def test_native_large_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    path = tmp_path / "big.fa"
    seqs = [bases[rng.integers(0, 4, size=int(n))] for n in rng.integers(10, 5000, 200)]
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n")
            b = bytes(s).decode()
            for j in range(0, len(b), 70):
                f.write(b[j : j + 70] + "\n")
    recs = list(fastx.read_fastx(str(path)))
    assert len(recs) == len(seqs)
    for r, s in zip(recs, seqs):
        assert bytes(r.seq) == bytes(s)


@pytest.mark.parametrize("layout", ["fasta_single_line", "fasta_wrapped",
                                    "fastq"])
def test_records_larger_than_the_batch_buffer(tmp_path, monkeypatch, layout):
    """A record that outgrows the batch buffer is re-read whole after the
    buffer grows: no record is dropped or split, whether it is the first
    of a batch or arrives after others."""
    if native.get_lib() is None:
        pytest.skip("libntpu_io.so not built")
    monkeypatch.setattr(native, "_SEQ_CAP", 256)
    monkeypatch.setattr(native, "_HDR_CAP", 64)
    rng = np.random.default_rng(4)
    lens = [100, 3000, 50, 700, 9000, 10, 255, 256, 257, 1200]
    seqs = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
            for n in lens]
    path = tmp_path / ("x.fq" if layout == "fastq" else "x.fa")
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            hdr = b"c%d %s" % (i, b"x" * (90 if i == 3 else 3))
            if layout == "fastq":
                f.write(b"@%s\n%s\n+\n%s\n" % (hdr, s, b"I" * len(s)))
            elif layout == "fasta_wrapped":
                lines = [s[j:j + 60] for j in range(0, len(s), 60)]
                f.write(b">%s\n%s\n" % (hdr, b"\n".join(lines)))
            else:
                f.write(b">%s\n%s\n" % (hdr, s))
    got = list(fastx.read_fastx(str(path)))
    assert [r.name for r in got] == [f"c{i}" for i in range(len(seqs))]
    assert [bytes(r.seq) for r in got] == seqs
    assert got[3].comment == "x" * 90
