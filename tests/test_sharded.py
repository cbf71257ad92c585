"""Distributed scanner tests on the 8-device virtual CPU mesh (the analogue
of testing multi-host logic single-host via 1xN meshes, SURVEY.md §4)."""

import jax
import numpy as np
import pytest

from sliceslice_tpu import BatchedSearcher, naive_find
from sliceslice_tpu.needle import build_probe_table
from sliceslice_tpu.ops.layout import preprocess
from sliceslice_tpu.ops.scan_math import SENTINEL
from sliceslice_tpu.parallel import (
    ShardedBatchedSearcher,
    make_mesh,
    sharded_find_cols,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="needs an 8-device mesh (the suite's virtual CPU devices)",
)


@pytest.fixture(scope="module")
def corpus(rng=np.random.default_rng(7)):
    return bytes(rng.integers(97, 103, (900_000,), dtype=np.uint8))


def _tables(needles, hay_len):
    values, masks, lengths = build_probe_table(needles)
    ends = np.maximum(hay_len - lengths + 1, 0).astype(np.int32)
    return values, masks, ends


def test_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_find_matches_oracle(corpus, shape):
    mesh = make_mesh(shape)
    dh = preprocess(corpus, kh=16)
    assert dh.g >= 2
    rng = np.random.default_rng(11)
    needles = [
        corpus[i : i + k]
        for k in (2, 4, 7, 12)
        for i in map(int, rng.integers(0, len(corpus) - k, (3,)))
    ] + [b"ZZZZ", corpus[-9:]]
    values, masks, ends = _tables(needles, dh.length)
    got = np.asarray(sharded_find_cols(dh, values, masks, ends, mesh))
    for nd, o in zip(needles, got):
        exp = naive_find(corpus, nd)
        assert (None if o >= SENTINEL else int(o)) == exp, nd


def test_shard_boundary_exactly_once(corpus):
    """Needles straddling shard boundaries are found exactly once with the
    correct global offset (exactly-once rule, SURVEY.md §5.7)."""
    mesh = make_mesh((8, 1))
    dh = preprocess(corpus, kh=16)
    seg = dh.seg_bytes
    needles = []
    for b in range(1, dh.g):
        needles.append(corpus[b * seg - 6 : b * seg + 6])
    values, masks, ends = _tables(needles, dh.length)
    got = np.asarray(sharded_find_cols(dh, values, masks, ends, mesh))
    for nd, o in zip(needles, got):
        assert int(o) == naive_find(corpus, nd), nd


def test_sharded_batched_searcher(corpus):
    mesh = make_mesh((4, 2))
    dh = preprocess(corpus, kh=16)
    needles = [corpus[10:15], b"absent!", corpus[500_000:500_020], b"a"]
    sb = ShardedBatchedSearcher(needles, mesh)
    got = sb.find_all(dh)
    exp = BatchedSearcher(needles).find_all(dh)
    assert (got == exp).all()
    # The >2 GiB pair path through the searcher (host int64 scatter).
    sb64 = ShardedBatchedSearcher(needles, mesh)
    sb64.force_int64 = True
    got64 = sb64.find_all(dh)
    assert got64.dtype == np.int64 and (got64 == exp).all()
    assert (sb64.count_all(dh) == BatchedSearcher(needles).count_all(dh)).all()


def test_pad_segments_mesh_bigger_than_corpus():
    """More devices than segments: pad segments must not fabricate matches."""
    rng = np.random.default_rng(3)
    data = bytes(rng.integers(97, 100, (600_000,), dtype=np.uint8))
    mesh = make_mesh((8, 1))
    dh = preprocess(data, kh=16)
    needles = [data[:4], b"\x00\x00\x00", data[-5:]]
    values, masks, ends = _tables(needles, dh.length)
    got = np.asarray(sharded_find_cols(dh, values, masks, ends, mesh))
    for nd, o in zip(needles, got):
        assert (None if o >= SENTINEL else int(o)) == naive_find(data, nd), nd


def test_make_global_corpus_single_process():
    """Single-process path of the multi-host corpus assembly."""
    import jax

    from sliceslice_tpu.parallel.distributed import global_mesh, make_global_corpus

    mesh = global_mesh()
    local = np.zeros((8, 64, 128), dtype=np.uint8)
    arr = make_global_corpus(local, mesh)
    assert arr.shape == (8 * jax.process_count(), 64, 128)


def test_initialize_noop():
    from sliceslice_tpu.parallel.distributed import initialize

    initialize(num_processes=1)  # must be a no-op


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_find_int64_pair_path(corpus, shape):
    """The >2 GiB component-pair path (two pmins + int64 host combine)
    returns the same exact offsets as the int32 device path, including
    shard-boundary straddles and absences."""
    mesh = make_mesh(shape)
    dh = preprocess(corpus, kh=16)
    seg = dh.seg_bytes
    rng = np.random.default_rng(23)
    needles = (
        [corpus[i : i + k] for k in (3, 8, 13)
         for i in map(int, rng.integers(0, len(corpus) - k, (2,)))]
        + [corpus[b * seg - 5 : b * seg + 5] for b in range(1, min(dh.g, 4))]
        + [b"ZZZZ", corpus[-7:]]
    )
    values, masks, ends = _tables(needles, dh.length)
    got = sharded_find_cols(dh, values, masks, ends, mesh, force_int64=True)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    for nd, o in zip(needles, got):
        exp = naive_find(corpus, nd)
        assert (None if o < 0 else int(o)) == exp, nd


def test_sharded_count_int64_pair_path(corpus):
    """Two-limb psum count path parity with the int32 psum path."""
    from sliceslice_tpu.needle import build_probe_table
    from sliceslice_tpu.parallel import sharded_count_cols
    from sliceslice_tpu.searcher import overlapping_count

    mesh = make_mesh((8, 1))
    dh = preprocess(corpus, kh=16)
    needles = [corpus[10:14], b"aab", b"absent!", b"a"]
    values, masks, lengths = build_probe_table(needles)
    ends = np.maximum(dh.length - lengths + 1, 0).astype(np.int64)
    got = sharded_count_cols(
        dh, values, masks, ends, mesh, force_int64=True
    )
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    exp = np.array([overlapping_count(corpus, nd) for nd in needles])
    assert (got == exp).all()


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_positions_matches_oracle(corpus, shape):
    """Sharded all-occurrence positions: per-shard bitmap + host decode with
    int64 global bases; exactly-once at shard boundaries."""
    from sliceslice_tpu.searcher import _host_positions

    mesh = make_mesh(shape)
    dh = preprocess(corpus, kh=16)
    seg = dh.seg_bytes
    needles = [
        corpus[100:104],          # frequent 4-byte
        b"aab",                   # very frequent 3-byte
        b"absent!",               # none
        corpus[seg - 3 : seg + 3],  # straddles shard boundary
        corpus[-6:],              # at the very end
    ]
    sb = ShardedBatchedSearcher(needles, mesh)
    got = sb.positions_all(dh)
    for nd, g in zip(needles, got):
        exp = _host_positions(corpus, nd)
        assert g.dtype == np.int64
        assert np.array_equal(g, exp), nd


def test_sharded_positions_function_level(corpus):
    """Direct sharded_positions call (homogeneous table, 8 data shards)."""
    from sliceslice_tpu.parallel import sharded_positions
    from sliceslice_tpu.searcher import _host_positions

    mesh = make_mesh((8, 1))
    dh = preprocess(corpus, kh=16)
    needles = [corpus[5:9], corpus[77:81], b"zzzz"]
    values, masks, lengths = build_probe_table(needles)
    ends = np.maximum(dh.length - lengths.astype(np.int64) + 1, 0)
    got = sharded_positions(dh, values, masks, ends, mesh)
    for nd, g in zip(needles, got):
        assert np.array_equal(g, _host_positions(corpus, nd)), nd


def test_int64_combine_math():
    """The host combine is exact past int32: synthetic (shard, local) pairs
    at multi-GiB magnitudes."""
    shard_bytes = 1 << 29  # 512 MiB shards
    kmin = np.array([0, 9, 100, 2**31 - 1], np.int64)  # last: absent
    lmin = np.array([5, shard_bytes - 1, 12345, 2**31 - 1], np.int64)
    out = np.where(kmin < 2**31 - 1, kmin * shard_bytes + lmin, -1)
    assert out[1] == 9 * shard_bytes + shard_bytes - 1  # ~5 GiB, exact
    assert out[2] == 100 * shard_bytes + 12345  # ~53 GiB, exact
    assert out[3] == -1
    assert out.dtype == np.int64


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_count_matches_oracle(corpus, shape):
    """Sharded counts: exactly-once across shard boundaries, one psum."""
    from sliceslice_tpu.searcher import overlapping_count

    mesh = make_mesh(shape)
    dh = preprocess(corpus, kh=16)
    seg = dh.seg_bytes
    needles = [corpus[10:14], b"aab", b"absent!", corpus[seg - 3 : seg + 3], b"a"]
    got = ShardedBatchedSearcher(needles, mesh).count_all(dh)
    exp = np.array([overlapping_count(corpus, nd) for nd in needles])
    assert (got == exp).all()


def test_sharded_searcher_consumes_global_corpus(corpus):
    """ShardedBatchedSearcher accepts a (single-process) GlobalCorpus —
    the multi-host corpus object — without relayout or bytes conversion."""
    from sliceslice_tpu.parallel.distributed import (
        assemble_global_corpus,
        global_mesh,
    )

    mesh = global_mesh()
    s = 96
    kh = 32
    seg = s * 128
    g = -(-len(corpus) // seg)
    g = -(-g // 8) * 8  # divisible by the 8-way data axis
    gc = assemble_global_corpus(
        corpus, b"", len(corpus), s, kh, mesh, g_local=g
    )
    needles = [corpus[100:108], corpus[seg - 3 : seg + 5], b"nope!", b"a"]
    sb = ShardedBatchedSearcher(needles, mesh)
    got = sb.find_all(gc)
    exp = [naive_find(corpus, nd) for nd in needles]
    assert list(got) == [(-1 if e is None else e) for e in exp]
    from sliceslice_tpu.searcher import overlapping_count

    cnt = sb.count_all(gc)
    assert list(cnt) == [overlapping_count(corpus, nd) for nd in needles]
    from sliceslice_tpu.searcher import _host_positions

    pos = sb.positions_all(gc)
    for nd, p in zip(needles, pos):
        assert np.array_equal(p, _host_positions(corpus, nd)), nd
    # Halo too small for the needle set -> clear error, no silent relayout.
    sb_wide = ShardedBatchedSearcher([corpus[:120]], mesh)
    with pytest.raises(ValueError, match="halo"):
        sb_wide.find_all(gc)


def test_sharded_long_needle_block_cap(corpus):
    """Long-needle sharded tables (slot-looped widths, kh = 1024) stay
    exact."""
    mesh = make_mesh((2, 1), jax.devices()[:2])
    dh = preprocess(corpus, kh=1024)
    needles = [corpus[1000:1000 + 900], corpus[5000:5000 + 901]]
    values, masks, lengths = build_probe_table(needles)
    ends = np.maximum(dh.length - lengths.astype(np.int64) + 1, 0)
    got = np.asarray(sharded_find_cols(dh, values, masks, ends, mesh))
    assert list(got) == [1000, 5000]


def test_sharded_cache_invalidates_on_optimize(corpus):
    """optimize_for permutes inner group rows; the sharded placed-table
    cache must invalidate (stale tables would pair old row order with new
    indices)."""
    mesh = make_mesh((4, 2))
    dh = preprocess(corpus, kh=16)
    needles = [corpus[10:15], b"absent!", corpus[700_000:700_012], b"a"]
    sb = ShardedBatchedSearcher(needles, mesh)
    before = sb.find_all(dh)
    sb.inner.optimize_for(dh)
    after = sb.find_all(dh)
    assert (before == after).all()
    # the sharded-level optimizer (measuring sweep runs on the mesh)
    sb.optimize_for(dh)
    assert (sb.find_all(dh) == before).all()
    from sliceslice_tpu.searcher import overlapping_count

    assert list(sb.count_all(dh)) == [
        overlapping_count(corpus, nd) for nd in needles
    ]


def test_placed_corpus_cache_alternate_drop_purge(corpus):
    """Regression for the weakref/id-reuse placed-corpus cache
    (ShardedBatchedSearcher._run_groups): alternating two corpora through
    one searcher reuses both cache entries; dropping one corpus leaves a
    dead weakref that the next insert purges; results stay exact
    throughout (ADVICE r3 item 1)."""
    import gc

    mesh = make_mesh((4, 2))
    needles = [corpus[10:15], b"absent!", b"a", corpus[444_444:444_452]]
    sb = ShardedBatchedSearcher(needles, mesh)
    bs = BatchedSearcher(needles)
    dh_a = preprocess(corpus, kh=16)
    data_b = corpus[::-1]
    dh_b = preprocess(data_b, kh=16)
    exp_a = bs.find_all(dh_a)
    exp_b = bs.find_all(dh_b)
    for _ in range(3):  # alternate: both entries stay resident
        assert (sb.find_all(dh_a) == exp_a).all()
        assert (sb.find_all(dh_b) == exp_b).all()
    assert len(sb._placed_corpus) == 2
    del dh_b
    gc.collect()
    # The dead entry is purged when the next distinct corpus is placed.
    data_c = corpus[:300_000]
    dh_c = preprocess(data_c, kh=16)
    exp_c = bs.find_all(dh_c)
    assert (sb.find_all(dh_c) == exp_c).all()
    keys_alive = [k for k, v in sb._placed_corpus.items() if v[0]() is not None]
    assert len(keys_alive) == len(sb._placed_corpus) == 2  # a + c, b purged
    assert (sb.find_all(dh_a) == exp_a).all()


def test_sharded_huge_dense_local_layout_cached(corpus, monkeypatch):
    """A repeated dense-tier huge-needle query over the same GlobalCorpus
    must issue NO corpus re-layout/upload: the process-local byte range is
    preprocessed once and memoized (VERDICT r4 item 6)."""
    from sliceslice_tpu.needle import MAX_NEEDLE_LEN
    from sliceslice_tpu.ops import layout as layout_mod
    from sliceslice_tpu.parallel.distributed import (
        assemble_global_corpus,
        global_mesh,
    )
    from sliceslice_tpu.searcher import overlapping_count

    # Period-1 adversarial content: every position passes the prefix
    # filter, forcing the dense tier on every process.
    k = MAX_NEEDLE_LEN + 2
    nd = b"a" * k
    hay = b"a" * 60_000 + b"b" + b"a" * 9_000
    mesh = global_mesh()
    s = 96
    seg = s * 128
    g = -(-(-(-len(hay) // seg)) // 8) * 8
    gc = assemble_global_corpus(hay, b"", len(hay), s, 64, mesh, g_local=g)
    sb = ShardedBatchedSearcher([nd], mesh)

    calls = []
    real = layout_mod.preprocess

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(layout_mod, "preprocess", counting)
    exp = overlapping_count(hay, nd)
    assert int(sb.count_all(gc)[0]) == exp
    first = len(calls)
    assert first >= 1  # the dense tier laid out the local range once
    assert int(sb.count_all(gc)[0]) == exp
    assert int(sb.find_all(gc)[0]) == hay.find(nd)
    assert len(calls) == first, "repeated dense query re-laid out the corpus"


def test_sharded_positions_two_tier_cap_split(corpus):
    """Sharded positions: sparse (needle, shard) cells ride the compact
    tier, over-cap cells fall back to the per-shard bitmap — exact parity
    either way, including a needle dense in one shard and absent in
    others."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    from sliceslice_tpu.needle import build_probe_table
    from sliceslice_tpu.parallel import make_mesh
    from sliceslice_tpu.parallel.shard_scan import sharded_positions
    from sliceslice_tpu.searcher import _host_positions

    mesh = make_mesh((4, 2))
    hay = bytearray(corpus[:200_000])
    # Dense cluster early (lands in shard 0): 40 occurrences of "ZZZQ".
    for i in range(40):
        p = 100 + i * 37  # overlapping-free, within one shard
        hay[p : p + 4] = b"ZZZQ"
    hay = bytes(hay)
    dh = preprocess(hay, force_cols=True, seg_rows=64)
    needles = [b"ZZZQ", hay[150_000 : 150_009], b"NOPE!", hay[0:2]]
    vals, msks, lens = build_probe_table(needles)
    ends = np.maximum(dh.length - lens + 1, 0)
    got = sharded_positions(dh, vals, msks, ends, mesh, sparse_cap=8)
    for nd, gpos in zip(needles, got):
        assert np.array_equal(gpos, _host_positions(hay, nd)), nd
