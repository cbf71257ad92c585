"""Edge/contract tests — the analogue of the reference's panic tests
(src/x86.rs:533-565): invalid position, empty needle, size mismatch."""

import numpy as np
import pytest

from sliceslice_tpu import (
    DynamicSearcher,
    EmptyNeedleSearcher,
    MemchrSearcher,
    PallasSearcher,
    XlaSearcher,
)
from sliceslice_tpu.models.pallas_searcher import SPECIALIZED


@pytest.mark.parametrize("cls", [PallasSearcher, XlaSearcher, MemchrSearcher])
def test_empty_needle_rejected(cls):
    # reference: Avx2Searcher::new / with_position panic (src/x86.rs:545-549)
    with pytest.raises(ValueError):
        cls(b"")


@pytest.mark.parametrize("cls", [PallasSearcher, XlaSearcher, DynamicSearcher])
def test_invalid_position_rejected(cls):
    # reference: position < size assert (src/x86.rs:533-543)
    with pytest.raises(ValueError):
        cls.with_position(b"abc", 3)
    with pytest.raises(ValueError):
        cls.with_position(b"abc", -1)
    cls.with_position(b"abc", 2)  # boundary ok


def test_dynamic_empty_needle_always_true():
    # reference N0 arm (src/x86.rs:470,500)
    d = DynamicSearcher(b"")
    assert isinstance(d.inner, EmptyNeedleSearcher)
    assert d.search_in(b"") is True
    assert d.search_in(b"anything") is True
    assert d.find(b"xyz") == 0
    with pytest.raises(ValueError):
        DynamicSearcher.with_position(b"", 1)


def test_dynamic_dispatch_arms():
    assert isinstance(DynamicSearcher(b"x").inner, MemchrSearcher)
    for k in range(2, 17):
        inner = DynamicSearcher(b"a" * k).inner
        assert type(inner).__name__ == f"Searcher{k}"
    assert type(DynamicSearcher(b"a" * 17).inner) is PallasSearcher


def test_specialized_size_mismatch():
    # reference: SIZE/len assert (src/x86.rs:551-565)
    with pytest.raises(ValueError):
        SPECIALIZED[4](b"abc")
    with pytest.raises(ValueError):
        SPECIALIZED[2](b"abc")


def test_memchr_requires_single_byte():
    with pytest.raises(ValueError):
        MemchrSearcher(b"ab")


def test_haystack_type_contract():
    s = DynamicSearcher(b"ab")
    assert s.find("xxab") == 2  # str accepted
    assert s.find(np.frombuffer(b"abyy", np.uint8)) == 0
    with pytest.raises(TypeError):
        s.find(np.zeros(4, np.int32))
    assert s.find(bytearray(b"zzzab")) == 3
    assert s.find(memoryview(b"ab")) == 0


def test_inlined_alias():
    s = DynamicSearcher(b"ab")
    assert s.inlined_search_in(b"xxab") is True
    assert PallasSearcher(b"ab").inlined_search_in(b"zz") is False


def test_exotic_final_mask_pen_full_exact():
    """Caller-built tables whose final mask is NOT a little-endian byte
    prefix stay exact: every probe slot compares under its own mask (r2
    regression: a premasked-window shortcut misclassified 0xFFFF0000 and
    returned a false negative)."""
    import struct

    from sliceslice_tpu.needle import build_probe_table
    from sliceslice_tpu.ops import scan_kernel
    from sliceslice_tpu.ops.layout import preprocess

    rng = np.random.default_rng(17)
    hay = bytearray(rng.integers(97, 105, (300_000,), dtype=np.uint8))
    hay[123_456:123_464] = b"QRSTUVWX"
    hay = bytes(hay)
    dh = preprocess(hay, kh=16)
    v0 = struct.unpack("<I", b"QRST")[0]
    v1 = struct.unpack("<I", b"UVWX")[0]
    # Exotic final mask: compare only the HIGH two bytes of the second
    # window (matches any needle b"QRST??WX").
    values = np.array([[v0, v1 & 0xFFFF0000]], np.uint32)
    masks = np.array([[0xFFFFFFFF, 0xFFFF0000]], np.uint32)
    ends = np.array([len(hay) - 8 + 1], np.int32)
    got = int(
        np.asarray(
            scan_kernel.batched_find_cols(
                None, values, masks, ends, s=dh.s, pw=dh.windows()
            )
        )[0]
    )
    assert got == 123_456
    # And through the sharded entry.
    import jax

    if len(jax.devices()) >= 2:
        from sliceslice_tpu.parallel import make_mesh, sharded_find_cols

        mesh = make_mesh((2, 1), jax.devices()[:2])
        got = int(
            np.asarray(sharded_find_cols(dh, values, masks, ends, mesh))[0]
        )
        assert got == 123_456
    # Prefix masks (the build_probe_table contract).
    vals2, msks2, lens2 = build_probe_table([b"QRSTUVW"])  # k=7: mask 0xFFFFFF
    ends2 = np.array([len(hay) - 7 + 1], np.int32)
    got = int(
        np.asarray(
            scan_kernel.batched_find_cols(
                None, vals2, msks2, ends2, s=dh.s, pw=dh.windows()
            )
        )[0]
    )
    assert got == 123_456


def test_width_gap_table_raises():
    """A mixed-width table straight from build_probe_table (width gap >= 2)
    once raised, because the kernels compared non-final slots unmasked (r2
    regression: a k=4 row in a t=4 table false-negatived).  Every slot now
    compares under its mask, so such a table must give exact find and
    count results instead."""
    from sliceslice_tpu.needle import build_probe_table
    from sliceslice_tpu.ops import scan_kernel
    from sliceslice_tpu.ops.layout import preprocess
    from sliceslice_tpu.searcher import overlapping_count

    hay = b"xxxxabcdyyyy" + bytes(20_000) + b"0123456789abcdef" + bytes(100)
    dh = preprocess(hay, kh=16, force_cols=True)
    needles = [b"abcd", b"0123456789abcdef"]
    values, masks, lengths = build_probe_table(needles)
    ends = np.maximum(len(hay) - lengths + 1, 0).astype(np.int32)
    first = scan_kernel.batched_find_cols(
        None, values, masks, ends, s=dh.s, pw=dh.windows()
    )
    assert list(np.asarray(first)) == [hay.find(nd) for nd in needles]
    counts = scan_kernel.batched_count_cols(
        None, values, masks, ends, s=dh.s, pw=dh.windows()
    )
    assert list(np.asarray(counts)) == [
        overlapping_count(hay, nd) for nd in needles
    ]


def test_sharded_width_gap_regroups_exactly():
    """The sharded entry point takes mixed widths in one table — and
    padding rows (all-zero masks, end 0) report nothing."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs a multi-device mesh")
    from sliceslice_tpu.needle import build_probe_table
    from sliceslice_tpu.ops.layout import preprocess
    from sliceslice_tpu.parallel import make_mesh, sharded_find_cols
    from sliceslice_tpu.ops.scan_math import SENTINEL

    rng = np.random.default_rng(3)
    hay = bytes(rng.integers(97, 102, (120_000,), dtype=np.uint8))
    dh = preprocess(hay, kh=16)
    needles = [hay[50:54], hay[60_000:60_016], b"nope"]
    values, masks, lengths = build_probe_table(needles)
    # Append an explicit padding row (mask 0, end 0).
    values = np.pad(values, ((0, 1), (0, 0)))
    masks = np.pad(masks, ((0, 1), (0, 0)))
    ends = np.append(
        np.maximum(len(hay) - lengths + 1, 0).astype(np.int64), 0
    )
    mesh = make_mesh((4, 1), jax.devices()[:4])
    got = np.asarray(sharded_find_cols(dh, values, masks, ends, mesh))
    exp = [hay.find(nd) for nd in needles]
    for e, o in zip(exp, got[:3]):
        assert (None if o >= SENTINEL else int(o)) == (None if e < 0 else e)
    assert got[3] >= SENTINEL  # padding row reports no match


def test_ensure_halo_cached_and_preserving():
    from sliceslice_tpu.ops.layout import preprocess

    data = bytes(np.random.default_rng(0).integers(97, 105, (40_000,),
                                                   dtype=np.uint8))
    dh = preprocess(data, kh=8, force_cols=True, windows_only=True)
    assert dh.cols is None and dh.pw is not None
    w1 = dh.ensure_halo(64)
    w2 = dh.ensure_halo(64)
    assert w1 is w2  # one cached rebuild, not one per call
    assert dh.ensure_halo(40) is w1  # smaller demands reuse the cache too
    assert dh.ensure_halo(dh.kh) is dh  # this layout suffices -> itself
    assert w1.kh >= 64
    assert w1.cols is None and w1.pw is not None  # windows_only preserved


def test_state_size_pinning():
    """The reference pins its searcher struct sizes (src/x86.rs:567-587:
    Avx2Searcher 128 B, DynamicAvx2Searcher 160 B) to catch accidental
    state bloat; the analogue here pins the preprocessed DEVICE state:
    probe tables are exactly 8 bytes per (needle, probe slot), and the
    corpus layout is ~5 bytes per corpus byte (1 tile + 4 window), ~4
    windows-only."""
    from sliceslice_tpu import BatchedSearcher
    from sliceslice_tpu.needle import num_probes
    from sliceslice_tpu.ops.layout import LANES, preprocess

    needles = [b"ab", b"abcde", b"abcdefghij", b"x" * 33]
    bs = BatchedSearcher(needles)
    for grp in bs.groups:
        assert grp.values_dev.dtype.itemsize == 4
        assert grp.values_dev.nbytes == grp.n_pad * grp.t * 4
        assert grp.masks_dev.nbytes == grp.n_pad * grp.t * 4
    # per-needle state: 8 bytes x ceil(k/4) slots (plus block padding)
    for nd in needles:
        assert num_probes(len(nd)) * 8 == 2 * 4 * -(-len(nd) // 4)

    data = bytes(np.random.default_rng(1).integers(97, 105, (200_000,),
                                                   dtype=np.uint8))
    dh = preprocess(data, kh=32)
    tile_b = dh.cols.nbytes
    win_b = dh.windows().nbytes
    total = dh.g * (dh.s + dh.kh) * LANES
    assert tile_b == total  # uint8 tiles: 1 byte per padded position
    assert win_b == dh.g * (dh.s + dh.kh - 3) * LANES * 4
    # Per PADDED position the footprint is exactly <= 5 bytes (1 tile +
    # 4 window; the window rows omit the last 3 halo rows), ~4 windows-only.
    assert (tile_b + win_b) / total <= 5.0
    dh2 = preprocess(data, kh=32, windows_only=True)
    assert dh2.cols is None
    assert dh2.windows().nbytes / total <= 4.0
