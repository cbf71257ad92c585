"""Pairwise short-haystack sweep: oracle-differential over random word sets
and a words.txt sample (reference short-haystack conformance shape)."""

import numpy as np

from sliceslice_tpu.ops.pairwise import PairwiseSearcher, pairwise_contains_all


def oracle_matrix(needles, haystacks):
    c = np.zeros((len(needles), len(haystacks)), dtype=bool)
    f = np.full((len(needles), len(haystacks)), -1, dtype=np.int32)
    for i, n in enumerate(needles):
        for j, h in enumerate(haystacks):
            pos = h.find(n)
            c[i, j] = pos >= 0
            f[i, j] = pos
    return c, f


def random_words(rng, count, max_len=12, alpha=(97, 101)):
    out = []
    for _ in range(count):
        k = int(rng.integers(0, max_len + 1))
        out.append(bytes(rng.integers(*alpha, (k,), dtype=np.uint8)))
    return out


def test_pairwise_random(rng):
    ws = random_words(rng, 60)
    c_exp, f_exp = oracle_matrix(ws, ws)
    ps = PairwiseSearcher(ws)
    assert (ps.contains_matrix() == c_exp).all()
    assert (ps.first_matrix() == f_exp).all()


def test_pairwise_distinct_haystacks(rng):
    nd = random_words(rng, 25, max_len=6)
    hs = random_words(rng, 40, max_len=10)
    c_exp, f_exp = oracle_matrix(nd, hs)
    ps = PairwiseSearcher(nd + [b"padlongerxx"])  # mw from needles
    ps = PairwiseSearcher(nd, block=16)  # also exercise multi-block tiling
    got_c = ps.contains_matrix(hs)
    got_f = ps.first_matrix(hs)
    assert (got_c == c_exp).all()
    assert (got_f == f_exp).all()


def test_pairwise_words_sample(words, rng):
    idx = rng.integers(0, len(words), (80,))
    ws = [words[int(i)] for i in idx]
    c_exp, f_exp = oracle_matrix(ws, ws)
    got = pairwise_contains_all(ws)
    assert (got == c_exp).all()


def test_pairwise_edge_cases():
    ws = [b"", b"a", b"aa", b"ab", b"ba", b"aba"]
    c_exp, f_exp = oracle_matrix(ws, ws)
    ps = PairwiseSearcher(ws)
    assert (ps.contains_matrix() == c_exp).all()
    assert (ps.first_matrix() == f_exp).all()


def test_count_matches_device(rng):
    ws = random_words(rng, 40)
    c_exp, _ = oracle_matrix(ws, ws)
    ps = PairwiseSearcher(ws, block=16)
    assert int(ps.count_matches_device()) == int(c_exp.sum())


def test_pairwise_pallas_block_differential(rng):
    """The Pallas pair-block (the GPU hot path) against the oracle and the
    portable XLA formulation, via the Pallas interpreter — the same
    wasmtime-style coverage the kernel tests use."""
    ws = random_words(rng, 35, max_len=14)
    hs = random_words(rng, 50, max_len=18)
    c_exp, f_exp = oracle_matrix(ws, hs)
    pallas = PairwiseSearcher(ws, block=16, use_pallas=True)
    xla = PairwiseSearcher(ws, block=16, use_pallas=False)
    assert (pallas.contains_matrix(hs) == c_exp).all()
    assert (pallas.first_matrix(hs) == f_exp).all()
    assert (pallas.first_matrix(hs) == xla.first_matrix(hs)).all()
    assert int(pallas.count_matches_device(hs)) == int(c_exp.sum())


def test_pairwise_pallas_edge_cases():
    ws = [b"", b"a", b"aa", b"ab", b"ba", b"aba", b"abcdefghijklmnop"]
    c_exp, f_exp = oracle_matrix(ws, ws)
    ps = PairwiseSearcher(ws, use_pallas=True)
    assert (ps.contains_matrix() == c_exp).all()
    assert (ps.first_matrix() == f_exp).all()


def test_fused_cache_does_not_pin_instances():
    # The sweep-program cache is module-level, keyed on the block plan:
    # searcher instances (and their device tables) must be collectable
    # after use in a long-running serving process.
    import gc
    import weakref

    words = [b"abc", b"abcd", b"zzz", b"bcda"]
    s = PairwiseSearcher(words)
    s.contains_matrix()
    ref = weakref.ref(s)
    del s
    gc.collect()
    assert ref() is None
