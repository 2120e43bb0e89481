"""The port's read scorers (ops/reads.py and the plain version of the
``score_reads`` kernel) against the JAX package's on the same reads."""

import os

import numpy as np
import pytest
import torch

from kmerlsh_tpu.kmer import codec
from kmerlsh_tpu.ops import reads as jreads
from kmerlsh_tpu_torch import kernels, testdata
from kmerlsh_tpu_torch.io import counts as countsio, fastq as fastqio
from kmerlsh_tpu_torch.ops import reads


def _device(seqs, diff, k, vote):
    return reads.score_part_device(seqs, diff, k, vote, device="cpu")


def _keys_of(seq: str, k: int) -> np.ndarray:
    codes, _ = codec.seq_to_codes(seq.encode())
    return codec.canonical_key(codec.sliding_kmers(codes, k), k)


def _reads(rng, marker, n=300):
    seqs = []
    for _ in range(n):
        ln = int(rng.integers(0, 90))
        if rng.random() < 0.4:
            start = int(rng.integers(0, 40))
            s = marker[start:start + ln]
        else:
            s = "".join(rng.choice(list("ACGTN"), size=ln))
        seqs.append(s.encode())
    seqs.append(b"")
    return seqs


@pytest.mark.parametrize("k", [7, 11, 16, 23, 31])
def test_device_scorer_matches_jax(k):
    """As test_pipeline.py's device-vs-host test: masks exact against the
    JAX package's host and device scorers and the native scorer."""
    rng = np.random.default_rng(7 + k)
    marker = "".join(rng.choice(list("ACGT"), size=80))
    diff = np.unique(_keys_of(marker, k))
    seqs = _reads(rng, marker)
    for vote in (0.3, 0.5, 1.0):
        got = _device(seqs, diff, k, vote)
        assert got.dtype == bool and got.shape == (len(seqs),)
        assert np.array_equal(got, jreads.score_part(seqs, diff, k, vote))
        assert np.array_equal(
            got, jreads.score_part_device(seqs, diff, k, vote)), (k, vote)
        assert np.array_equal(got, reads.score_part(seqs, diff, k, vote))
        assert np.array_equal(got, reads.score_part_native(seqs, diff, k,
                                                           vote))
        if vote == 0.5:
            assert 0 < got.sum() < len(seqs)


@pytest.mark.parametrize("scorer", ["host", "device", "native"])
def test_reference_semantics(scorer):
    """The cases of test_pipeline.py test_score_part_reference_semantics."""
    fn = {"host": reads.score_part, "device": _device,
          "native": reads.score_part_native}[scorer]
    k = 11
    rng = np.random.default_rng(0)
    marker = "".join(rng.choice(list("ACGT"), size=60))
    diff = np.sort(_keys_of(marker, k))
    other = "".join(rng.choice(list("ACGT"), size=60))
    half = marker[:30] + other[:30]
    short = marker[: k + 9]          # len = k+9 < k+10 → never selected
    exact_min = marker[: k + 10]     # len = k+10 → eligible
    seqs = [marker.encode(), other.encode(), half.encode(), short.encode(),
            exact_min.encode(), b""]
    assert list(fn(seqs, diff, k, 0.5)) == [True, False, False, False, True,
                                            False]
    rc = marker.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    assert list(fn([rc.encode()], diff, k, 0.5)) == [True]
    # strict '>': a ratio of exactly 1.0 is not selected at vote 1.0
    assert list(fn([marker.encode()], diff, k, 1.0)) == [False]


def test_empty_diff_and_n_bases():
    assert list(_device([b"ACGTACGTACGTACGTACGT"], np.empty(0, np.uint64), 7,
                        0.5)) == [False]
    k = 7
    poly_a = np.unique(codec.canonical_key(
        codec.sliding_kmers(np.zeros(30, np.uint8), k), k))
    assert list(_device([b"N" * 30], poly_a, k, 0.5)) == [True]
    assert list(_device([], poly_a, k, 0.5)) == []


@pytest.mark.parametrize("top", [True, False])
def test_keys_by_top_bit(top):
    """uint64 keys with the top bit set sort above the others: a set made
    only of such keys, and one with none of them, score as on the host."""
    k = 31
    rng = np.random.default_rng(3)
    src = ["".join(rng.choice(list("ACGT"), size=150)) for _ in range(40)]
    keys = np.unique(np.concatenate([_keys_of(s, k) for s in src]))
    high = (keys >> np.uint64(63)) == 1
    assert 0 < high.sum() < len(keys)
    diff = keys[high] if top else keys[~high]
    seqs = [s.encode() for s in src]
    seqs += ["".join(rng.choice(list("ACGT"), size=150)).encode()
             for _ in range(40)]
    for vote in (0.5, 0.3, 0.2):
        want = jreads.score_part(seqs, diff, k, vote)
        assert np.array_equal(_device(seqs, diff, k, vote), want)
    # about half of a source's windows hit: all pass at 0.2
    assert want[:40].all() and not want[40:].any()


def test_plain_kernel_hits_every_window_of_the_set():
    """score_reads_plain on a packed part: a read made of set k-mers only
    scores every window, its neighbour none."""
    k = 15
    rng = np.random.default_rng(5)
    a = "".join(rng.choice(list("ACGT"), size=100))
    b = "".join(rng.choice(list("ACGT"), size=100))
    diff = np.unique(_keys_of(a, k))
    codes, ws, nw, lens = reads.pack_part([a.encode(), b.encode()], k)
    assert list(ws) == [0, 100 + k - 1] and list(nw) == [86, 86]
    assert len(codes) == 200 + (k - 1) + k
    t = [torch.from_numpy(x) for x in (codes, ws, nw, lens)]
    keys = torch.from_numpy(diff.view(np.int64))
    # vote just under 1: a, whose every window hits, passes; b does not
    got = kernels.score_reads(*t, keys, k, 0.999)
    assert got.tolist() == [True, False]


# --- the mode-E input writers of testdata (chip_smoke.py phases 4 and 6) ---

def test_marker_keys_are_the_windows_keys():
    rng = np.random.default_rng(6)
    markers = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(5)]
    for k in (15, 31):
        want = np.unique(np.concatenate([_keys_of(m, k) for m in markers]))
        assert np.array_equal(testdata.marker_keys(markers, k), want)


def test_write_hex_reads_back(tmp_path):
    rng = np.random.default_rng(7)
    src = rng.integers(0, 4, size=(30, 50), dtype=np.uint8)
    keys = testdata.window_keys(src, 21)
    assert (keys >= np.uint64(1 << 63)).any()          # top bit kept
    path = str(tmp_path / countsio.HEX_NAME)
    testdata.write_hex(path, keys)
    assert np.array_equal(countsio.read_hex(path), keys)


def test_write_source_fastqs_parse(tmp_path):
    rng = np.random.default_rng(8)
    src = rng.integers(0, 4, size=(20, 40), dtype=np.uint8)
    paths = testdata.write_source_fastqs(str(tmp_path), src, 2, 300, seed=9)
    assert [os.path.basename(p) for p in paths] == ["sample00.fastq",
                                                    "sample01.fastq"]
    srcs = {bytes(codec.CODE_TO_BASE[s]) for s in src}
    for path in paths:
        got = [r for part in fastqio.read_parts([path]) for r in part]
        assert [r.name for r in got] == [b"r%08d" % i for i in range(300)]
        assert all(len(r.seq) == 40 and r.qual == b"I" * 40 for r in got)
        copies = sum(r.seq in srcs for r in got)
        assert 0.3 * 300 < copies < 0.6 * 300          # half, some mutated
