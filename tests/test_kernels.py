"""The scan kernels and their plain XLA formulations: the Triton kernels in
interpret mode against the oracle, the wrappers' padding and block plan, and
(``gpu``-marked) the compiled kernels against XLA at real widths."""

import numpy as np
import pytest

import sliceslice_tpu as st
from sliceslice_tpu.needle import build_probe_table
from sliceslice_tpu.ops import scan_kernel, xla_backend
from sliceslice_tpu.ops.layout import preprocess
from sliceslice_tpu.ops.scan_math import SENTINEL
from sliceslice_tpu.searcher import _host_positions, overlapping_count


def _first(x):
    return [-1 if v >= SENTINEL else int(v) for v in np.asarray(x)]


@pytest.fixture(scope="module")
def planted():
    """Three-letter filler over several 64 KiB segments, matches planted on
    both sides of segment edges and at the very end."""
    rng = np.random.default_rng(11)
    hay = bytearray(rng.integers(97, 100, (300_000,), dtype=np.uint8))
    for p, nd in [(65_530, b"EDGE-X"), (131_070, b"EDGE-X"), (299_990, b"TAIL")]:
        hay[p : p + len(nd)] = nd
    hay = bytes(hay)
    return hay, preprocess(hay, kh=96)


def _needles(hay, rng, n, kmax):
    out = []
    for _ in range(n):
        k = int(rng.integers(1, kmax + 1))
        i = int(rng.integers(0, len(hay) - k))
        out.append(hay[i : i + k])
    return out + [b"EDGE-X", b"TAIL", b"ABSENT", b"\x00"]


@pytest.mark.parametrize("kmax", [4, 16, 90])
def test_find_kernel_matches_oracle(planted, kmax):
    """Mixed widths in one table, short and long (slot-loop) tables."""
    hay, dh = planted
    needles = _needles(hay, np.random.default_rng(kmax), 13, kmax)
    v, m, lens = build_probe_table(needles)
    ends = np.maximum(len(hay) - lens + 1, 0).astype(np.int32)
    got = scan_kernel.batched_find_cols(None, v, m, ends, s=dh.s, pw=dh.windows())
    assert _first(got) == [hay.find(nd) for nd in needles]


def test_find_kernel_split_early_exit(planted):
    """Few needles over many segments: the corpus is split across programs
    (one segment each), and the cross-split minimum must still be the
    FIRST match — including a needle found only in a late split and one
    found in every split."""
    hay, dh = planted
    n_pad = scan_kernel.plan_block(3)
    assert scan_kernel.plan_splits(n_pad // scan_kernel.NEEDLE_BLOCK, dh.g) == dh.g
    needles = [b"TAIL", b"aab", b"EDGE-X"]
    v, m, lens = build_probe_table(needles)
    ends = np.maximum(len(hay) - lens + 1, 0).astype(np.int32)
    got = scan_kernel.batched_find_cols(None, v, m, ends, s=dh.s, pw=dh.windows())
    assert _first(got) == [hay.find(nd) for nd in needles]


def test_find_ends_clamp(planted):
    """``ends`` below the corpus end (streaming window clamps) drop
    matches at or past them, exactly."""
    hay, dh = planted
    needles = [b"EDGE-X", b"EDGE-X", b"TAIL"]
    v, m, _ = build_probe_table(needles)
    ends = np.array([65_530, 65_531, 10], np.int32)
    got = scan_kernel.batched_find_cols(None, v, m, ends, s=dh.s, pw=dh.windows())
    assert _first(got) == [-1, 65_530, -1]


@pytest.mark.parametrize("n", [1, 7, 8, 9, 23])
def test_plan_block_padding(n):
    n_pad = scan_kernel.plan_block(n)
    assert n_pad % scan_kernel.NEEDLE_BLOCK == 0 and n <= n_pad < n + 8
    assert scan_kernel.plan_block(n, shards=4) % (4 * scan_kernel.NEEDLE_BLOCK) == 0


def test_plan_splits_bounds():
    assert scan_kernel.plan_splits(1, 1) == 1
    assert scan_kernel.plan_splits(1, 5000) == scan_kernel.TARGET_PROGRAMS
    assert scan_kernel.plan_splits(4096, 14) == 1
    assert 1 <= scan_kernel.plan_splits(100, 14) <= 14


def test_find_raw_rejects_unpadded_and_short_halo(planted):
    import jax.numpy as jnp

    _, dh = planted
    v = jnp.zeros((3, 1), jnp.uint32)
    with pytest.raises(AssertionError, match="plan_block"):
        scan_kernel.find_raw(v, v, dh.windows(), dh.s)
    wide = jnp.zeros((8, 40), jnp.uint32)  # 159 halo bytes > kh = 96
    with pytest.raises(AssertionError, match="halo"):
        scan_kernel.find_raw(wide, wide, dh.windows(), dh.s)


def test_xla_count_matches_oracle(planted):
    hay, dh = planted
    needles = _needles(hay, np.random.default_rng(5), 10, 12)
    v, m, lens = build_probe_table(needles)
    ends = np.maximum(len(hay) - lens + 1, 0).astype(np.int32)
    got = xla_backend.count_batched_cols(dh.windows(), v & m, m, ends, dh.s)
    assert list(np.asarray(got)) == [overlapping_count(hay, nd) for nd in needles]
    # Through the public wrapper (padding to the block plan).
    got = scan_kernel.batched_count_cols(None, v, m, ends, s=dh.s, pw=dh.windows())
    assert list(np.asarray(got)) == [overlapping_count(hay, nd) for nd in needles]


@pytest.mark.parametrize("byte", [b"a", b"E", b"T", b"#"])
def test_xla_memchr_matches_oracle(planted, byte):
    hay, dh = planted
    got = int(xla_backend.memchr_cols(dh.cols, byte[0], len(hay), dh.s))
    exp = hay.find(byte)
    assert (got if got < SENTINEL else -1) == exp
    # An end at the first match hides it.
    if exp > 0:
        got = int(xla_backend.memchr_cols(dh.cols, byte[0], exp, dh.s))
        assert got == SENTINEL or hay.find(byte, 0, exp) == got


def test_memchr_searcher_counts_and_positions(planted):
    hay, dh = planted
    s = st.MemchrSearcher(b"T")
    assert s.find(dh) == hay.find(b"T")
    assert s.count_in(dh) == overlapping_count(hay, b"T")
    assert list(s.positions(dh)) == list(_host_positions(hay, b"T"))


# -- compiled kernels on the card -------------------------------------------


@pytest.fixture(scope="module")
def i386():
    hay = open("data/i386.txt", "rb").read()
    words = [w for w in open("data/words.txt", "rb").read().split(b"\n") if w]
    return hay, words


@pytest.mark.gpu
def test_gpu_find_kernel_vs_xla_i386(i386):
    """Compiled find kernel vs the XLA formulation, every word x i386."""
    hay, words = i386
    dh = preprocess(hay)
    for t in range(1, 7):
        sel = [w for w in words if -(-len(w) // 4) == t]
        v, m, lens = build_probe_table(sel)
        ends = np.maximum(len(hay) - lens + 1, 0).astype(np.int32)
        kern = scan_kernel.batched_find_cols(None, v, m, ends, s=dh.s, pw=dh.windows())
        ref = xla_backend.find_batched_cols(dh.cols, v & m, m, ends, dh.s)
        assert (np.asarray(kern) == np.asarray(ref)).all(), t


@pytest.mark.gpu
def test_gpu_pair_kernel_vs_xla(i386):
    """Compiled pair-block kernel vs the XLA scan, every ordered pair."""
    _, words = i386
    ws = sorted(words, key=len)
    kern = st.PairwiseSearcher(ws).first_matrix()
    ref = st.PairwiseSearcher(ws, use_pallas=False).first_matrix()
    assert (kern == ref).all()


@pytest.mark.gpu
def test_gpu_batched_sweeps_vs_oracle(i386):
    """The fused find and count sweeps at full width against the oracle."""
    hay, words = i386
    dh = preprocess(hay)
    bs = st.BatchedSearcher(words)
    assert list(bs.find_all(dh)) == [hay.find(w) for w in words]
    sub = words[::50]
    assert list(st.BatchedSearcher(sub).count_all(dh)) == [
        overlapping_count(hay, w) for w in sub
    ]
