"""Portable XLA (non-Pallas) search paths.

The role of the reference's portable ``StdSimdSearcher`` (src/stdsimd.rs) —
one algorithm expressed through the compiler's portable vector model, running
on any JAX backend (CPU/GPU), used both as the short-haystack rung of the
dispatch ladder and as a differential-testing reference for the Pallas
kernels (the way the reference tests wasm under wasmtime, check.yml).

Probe slot ``t`` compares the packed 4-byte window at static offset ``4*t``
(see needle.probe_program).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .scan_math import (
    SENTINEL,
    first_offset,
    packed_windows,
    probe_acc,
    segment_positions,
    value_slicer,
)


@jax.jit
def _find_flat_impl(flat, values, masks, end):
    """flat: uint8[(Lp,)]; values/masks: [(T,)]; end scalar -> first offset."""
    h = flat.astype(jnp.uint32)
    p = (
        h
        | (jnp.roll(h, -1) << 8)
        | (jnp.roll(h, -2) << 16)
        | (jnp.roll(h, -3) << 24)
    )
    lp = flat.shape[0]
    acc = None
    for t in range(values.shape[0]):
        pt = jnp.roll(p, -4 * t) if t else p
        # Pre-masked table values (needle.py contract): 2-op masked compare.
        eq = (pt & masks[t]) == values[t]
        acc = eq if acc is None else jnp.logical_and(acc, eq)
    idx = jnp.arange(lp, dtype=jnp.int32)
    valid = jnp.logical_and(acc, idx < end)
    return jnp.min(jnp.where(valid, idx, SENTINEL))


def find_flat(flat, values, masks, end):
    """First match offset (or SENTINEL) of one probe program over a flat
    zero-padded uint8 haystack.  Wrap-around from the rolls only touches
    positions masked by ``end``, so semantics are exact."""
    return _find_flat_impl(
        flat,
        jnp.asarray(values, jnp.uint32),
        jnp.asarray(masks, jnp.uint32),
        jnp.asarray(end, jnp.int32),
    )


@functools.partial(jax.jit, static_argnums=(4,))
def _find_cols_impl(cols, values, masks, end, s):
    seg = s * 128
    t_num = values.shape[0]

    def body(g, best):
        tile = jax.lax.dynamic_index_in_dim(cols, g, axis=0, keepdims=False)
        p = packed_windows(tile)
        probes = [(4 * t, values[t], masks[t]) for t in range(t_num)]
        acc = probe_acc(value_slicer(p, s), probes)
        fl = first_offset(acc, end - g * seg, s)
        fg = jnp.where(fl < SENTINEL, fl + g * seg, SENTINEL)
        return jnp.minimum(best, fg)

    return jax.lax.fori_loop(0, cols.shape[0], body, jnp.int32(SENTINEL))


def find_cols(cols, values, masks, end, s: int):
    """First match over the tiled (G, S+KH, 128) column layout — same math as
    the Pallas kernel, expressed as plain XLA."""
    return _find_cols_impl(
        cols,
        jnp.asarray(values, jnp.uint32),
        jnp.asarray(masks, jnp.uint32),
        jnp.asarray(end, jnp.int32),
        s,
    )


@functools.partial(jax.jit, static_argnums=(4,))
def _find_batched_cols_impl(cols, values, masks, ends, s):
    def one(vals, msks, end):
        return _find_cols_impl(cols, vals, msks, end, s)

    return jax.vmap(one)(values, masks, ends)


def find_batched_cols(cols, values, masks, ends, s: int):
    """Vectorized multi-needle variant (N, T) tables -> (N,) first offsets."""
    return _find_batched_cols_impl(
        cols,
        jnp.asarray(values, jnp.uint32),
        jnp.asarray(masks, jnp.uint32),
        jnp.asarray(ends, jnp.int32),
        s,
    )


@functools.partial(jax.jit, static_argnums=(4,))
def _count_batched_impl(pw, values, masks, ends, s):
    seg = s * 128
    t_num = values.shape[1]
    pos = segment_positions(s)

    def one(vals, msks, end):
        def body(g, total):
            p = jax.lax.dynamic_index_in_dim(pw, g, axis=0, keepdims=False)
            probes = [(4 * t, vals[t], msks[t]) for t in range(t_num)]
            acc = probe_acc(value_slicer(p, s), probes)
            valid = jnp.logical_and(acc, pos < end - g * seg)
            return total + jnp.sum(valid.astype(jnp.int32))

        return jax.lax.fori_loop(0, pw.shape[0], body, jnp.int32(0))

    return jax.vmap(one)(values, masks, ends)


def count_batched_cols(pw, values, masks, ends, s: int):
    """Overlapping occurrence counts (int32[N]) of (N, T) probe tables over
    the layout's packed windows ``pw`` (g, rows, 128) — the same
    ``probe_acc`` math as :func:`find_batched_cols` with a masked sum in
    place of the first-offset min."""
    return _count_batched_impl(
        pw,
        jnp.asarray(values, jnp.uint32),
        jnp.asarray(masks, jnp.uint32),
        jnp.asarray(ends, jnp.int32),
        s,
    )


@functools.partial(jax.jit, static_argnums=(3,))
def _memchr_impl(cols, byte, end, s):
    seg = s * 128
    tile = cols[:, :s, :]
    pos = (
        jax.lax.broadcasted_iota(jnp.int32, tile.shape, 0) * seg
        + segment_positions(s)[None]
    )
    hit = jnp.logical_and(tile == byte, pos < end)
    return jnp.min(jnp.where(hit, pos, SENTINEL))


def memchr_cols(cols, byte: int, end, s: int):
    """First offset of one byte over the tiled uint8 layout (SENTINEL when
    absent): one fused ``min(where(byte == b, pos, SENTINEL))`` over every
    position, the 1-byte rung of the dispatch ladder."""
    return _memchr_impl(
        cols, jnp.asarray(byte, jnp.uint8), jnp.asarray(end, jnp.int32), s
    )


@jax.jit
def _find_batched_flat_impl(flat, values, masks, ends):
    def one(vals, msks, end):
        return _find_flat_impl(flat, vals, msks, end)

    return jax.vmap(one)(values, masks, ends)


def find_batched_flat(flat, values, masks, ends):
    return _find_batched_flat_impl(
        flat,
        jnp.asarray(values, jnp.uint32),
        jnp.asarray(masks, jnp.uint32),
        jnp.asarray(ends, jnp.int32),
    )


# -- all-occurrence positions: packed match bitmaps --------------------------
#
# Capability extension (the reference returns bool only; memchr-class
# libraries expose find_iter): evaluate every position and return a packed
# uint32 bitmap, 1/8th the corpus in bytes, decoded to sorted offsets on
# host.  Full scan by construction (an absence proof needs one anyway), so
# the portable XLA formulation is already at bandwidth; no Pallas variant
# needed.


@functools.partial(jax.jit, static_argnums=(4,))
def _match_bitmap_cols_impl(cols, values, masks, end, s):
    seg = s * 128
    t_num = values.shape[0]

    def one_seg(tile, g_idx):
        p = packed_windows(tile)
        probes = [(4 * t, values[t], masks[t]) for t in range(t_num)]
        acc = probe_acc(value_slicer(p, s), probes)  # (s, 128) bool
        pos = segment_positions(s) + g_idx * seg
        valid = jnp.logical_and(acc, pos < end)
        # Pack 32 consecutive rows per lane into one word: bit b of
        # word [q, lane] = match at row 32*q + b (decode in
        # decode_match_bitmap).  Disjoint bits, so a sum is an OR.
        w = valid.reshape(s // 32, 32, 128).astype(jnp.uint32)
        shifts = jnp.arange(32, dtype=jnp.uint32)[None, :, None]
        return jnp.sum(w << shifts, axis=1, dtype=jnp.uint32)

    return jax.vmap(one_seg)(cols, jnp.arange(cols.shape[0]))


def match_bitmap_cols(cols, values, masks, end, s: int):
    """Packed match bitmap over the tiled layout: uint32[(G, S/32, 128)],
    bit ``b`` of word ``[g, q, lane]`` set iff a valid match starts at
    ``pos = g*S*128 + lane*S + 32*q + b`` (``pos < end`` applied)."""
    return _match_bitmap_cols_impl(
        cols,
        jnp.asarray(values, jnp.uint32),
        jnp.asarray(masks, jnp.uint32),
        jnp.asarray(end, jnp.int32),
        s,
    )


@functools.partial(jax.jit, static_argnums=(4,))
def _match_bitmap_batched_impl(cols, values, masks, ends, s):
    def one(vals, msks, end):
        return _match_bitmap_cols_impl(cols, vals, msks, end, s)

    return jax.vmap(one)(values, masks, ends)


def match_bitmap_batched(cols, values, masks, ends, s: int):
    """Batched :func:`match_bitmap_cols`: (N, T) probe tables ->
    uint32[(N, G, S/32, 128)] packed bitmaps (N * corpus/8 bytes — batch
    callers should chunk N)."""
    return _match_bitmap_batched_impl(
        cols,
        jnp.asarray(values, jnp.uint32),
        jnp.asarray(masks, jnp.uint32),
        jnp.asarray(ends, jnp.int32),
        s,
    )


#: Segments per step of the compact-positions walk: bounds its live
#: per-position temporaries (a top_k input cannot fuse away) to
#: batch x COMPACT_SEGS x segment positions instead of the whole corpus.
COMPACT_SEGS = 16


@functools.partial(jax.jit, static_argnums=(4, 5))
def _compact_positions_impl(cols, values, masks, end, s, cap):
    """Single needle: (count, the ``cap`` smallest valid match offsets,
    int32 ascending, SENTINEL-filled past the count)."""
    seg = s * 128
    t_num = values.shape[0]
    k_seg = min(cap, seg)

    def one_seg(args):
        tile, g_idx = args
        p = packed_windows(tile)
        probes = [(4 * t, values[t], masks[t]) for t in range(t_num)]
        acc = probe_acc(value_slicer(p, s), probes)  # (s, 128) bool
        pos = segment_positions(s) + g_idx * seg
        valid = jnp.logical_and(acc, pos < end)
        cnt = jnp.sum(valid.astype(jnp.int32))
        flat = jnp.where(valid, pos, SENTINEL).reshape(-1)
        # cap smallest positions of this segment: top_k of the negation
        # (descending -pos == ascending pos).
        return cnt, -jax.lax.top_k(-flat, k_seg)[0]

    counts, parts = jax.lax.map(
        one_seg, (cols, jnp.arange(cols.shape[0])), batch_size=COMPACT_SEGS
    )
    allp = parts.reshape(-1)
    k = min(cap, allp.size)
    top = -jax.lax.top_k(-allp, k)[0]
    if k < cap:
        top = jnp.concatenate(
            [top, jnp.full((cap - k,), SENTINEL, jnp.int32)]
        )
    return jnp.sum(counts), top


def compact_positions(cols, values, masks, end, s: int, cap: int):
    """Single-needle :func:`compact_positions_batched`: (count int32,
    offsets int32[cap] ascending, SENTINEL-filled)."""
    return _compact_positions_impl(
        cols,
        jnp.asarray(values, jnp.uint32),
        jnp.asarray(masks, jnp.uint32),
        jnp.asarray(end, jnp.int32),
        s,
        int(cap),
    )


@functools.partial(jax.jit, static_argnums=(4, 5))
def _compact_positions_batched_impl(cols, values, masks, ends, s, cap):
    def one(vals, msks, end):
        return _compact_positions_impl(cols, vals, msks, end, s, cap)

    return jax.vmap(one)(values, masks, ends)


def compact_positions_batched(cols, values, masks, ends, s: int, cap: int):
    """Size-bounded ALL-positions scan: (counts int32[N], offsets
    int32[N, cap] ascending, SENTINEL-filled).  For needles with at most
    ``cap`` matches the offsets are complete and exact — the readback is
    ``cap`` words per needle instead of the bitmap's corpus/8 bytes
    (~1000x less for sparse needles); rows with ``count > cap`` hold the
    ``cap`` EARLIEST matches and the caller falls back to the bitmap for
    those needles (positions_all / streaming do this automatically)."""
    return _compact_positions_batched_impl(
        cols,
        jnp.asarray(values, jnp.uint32),
        jnp.asarray(masks, jnp.uint32),
        jnp.asarray(ends, jnp.int32),
        s,
        int(cap),
    )


#: Default sparse-positions budget shared by every two-tier positions
#: path (single-needle, batched, streaming, sharded cells).
SPARSE_POSITIONS_CAP = 4096


def two_tier_positions(cols, values, masks, ends, s: int, cap: int) -> list:
    """The shared two-tier all-positions protocol over one batch: compact
    scan first (``cap`` words of readback per needle); rows whose device
    count exceeds the cap re-decode from the packed bitmap of the FULL
    batch — the full-batch shape is what warmups compile, so a dense
    needle never pays a mid-batch jit of a subset shape.  Returns a list
    of int64 ascending offset arrays, one per needle row."""
    import numpy as np

    es = np.asarray(ends, np.int32)
    cnt, pos = compact_positions_batched(cols, values, masks, es, s, cap)
    cnt = np.asarray(cnt)
    pos = np.asarray(pos)
    out: list = [None] * len(values)
    dense = [j for j in range(len(values)) if cnt[j] > cap]
    for j in range(len(values)):
        if cnt[j] <= cap:
            out[j] = pos[j, : cnt[j]].astype(np.int64)
    if dense:
        words = np.asarray(
            match_bitmap_batched(cols, values, masks, es, s)
        )
        for j in dense:
            out[j] = decode_match_bitmap(words[j], s)
    return out


def decode_match_bitmap(words: "np.ndarray", s: int) -> "np.ndarray":
    """Decode :func:`match_bitmap_cols` output to sorted match offsets
    (int64[M], ascending).  Prefers the native C++ decoder (popcount-sized
    output, ctz walk — csrc/swarscan.cpp) and falls back to the numpy
    unpackbits decode, which materializes 8x the bitmap in bytes."""
    from ..utils import native

    out = native.decode_bitmap(words, s)
    if out is not None:
        return out
    return decode_match_bitmap_numpy(words, s)


def decode_match_bitmap_numpy(words: "np.ndarray", s: int) -> "np.ndarray":
    """Pure-numpy reference decode (kept as the no-toolchain fallback and
    the differential oracle for the native decoder)."""
    import numpy as np

    words = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    g, q, lanes = words.shape
    seg = s * lanes
    bits = np.unpackbits(
        words.view(np.uint8).reshape(g, q, lanes, 4), axis=-1,
        bitorder="little",
    ).reshape(g, q, lanes, 32)
    gg, qq, ll, bb = np.nonzero(bits)
    pos = (
        gg.astype(np.int64) * seg
        + ll.astype(np.int64) * s
        + 32 * qq.astype(np.int64)
        + bb.astype(np.int64)
    )
    pos.sort()
    return pos


# -- chained bitmaps: device-side verify for huge needles --------------------
#
# A needle longer than the probe-table budget is split into fixed chunks; each
# chunk is itself a probe table, and the needle matches at ``p`` iff chunk j
# matches at ``p + j*CHUNK``.  The packed bitmap layout is contiguous per
# lane (word [g, q, lane] covers positions g*seg + lane*s + 32q .. +31), so a
# transpose to (g, lane, q) linearizes it — and chunk offsets that are
# multiples of 32 become plain word-index shifts, making the cross-chunk AND
# a fused slice+AND chain.  Identical chunks (periodic adversarial needles)
# share ONE bitmap pass via ``chunk_map``, so the period-1 worst case that
# degrades a candidate-verify scheme to O(len*k) host work runs here at
# ~one-scan cost.  This replaces the reference's serial memcmp verify
# (src/lib.rs:199-251) at coarse grain with dense, branch-free vector work —
# exact for find/count/positions at any needle length.


def bitmap_linear(words):
    """(G, S/32, 128) packed words -> flat ascending-position word vector."""
    g, q, lanes = words.shape
    return words.transpose(0, 2, 1).reshape(g * lanes * q)


def bitmap_from_linear(linear, g: int, q: int, lanes: int = 128):
    """Inverse of :func:`bitmap_linear` (back to the decoder's layout)."""
    return linear.reshape(g, lanes, q).transpose(0, 2, 1)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _chained_bitmap_impl(pw, uniq_tables, uniq_ends, chunk_map, word_shifts, s):
    """Consumes the layout's PRE-PACKED windows (no byte tiles needed) and
    walks segments with ``lax.map`` + a ``fori_loop`` probe chain, so live
    temporaries stay segment-sized: one (s, 128) accumulator and one probe
    window per step.  (A vmapped unrolled-probe formulation materialized
    per-probe corpus-sized intermediates — 20+ GB of HLO temps on a 120 MB
    corpus; r4.)"""
    g = pw.shape[0]
    seg = s * 128
    BLK = 8  # probes per unrolled block (tables pre-padded to a multiple)

    def chunk_bitmap(values, masks, end):
        t_num = values.shape[0]
        assert t_num % BLK == 0, "chained tables must be padded to BLK"

        def one_seg(args):
            p, gi = args

            def body(b, acc):
                # One dynamic slice per BLOCK, static slices within it:
                # 8 fused compares per loop step instead of one.
                base = 4 * BLK * b
                big = jax.lax.dynamic_slice_in_dim(
                    p, base, s + 4 * (BLK - 1), axis=0
                )
                for j in range(BLK):
                    acc = jnp.logical_and(
                        acc,
                        (big[4 * j : 4 * j + s] & masks[BLK * b + j])
                        == values[BLK * b + j],
                    )
                return acc

            acc = jax.lax.fori_loop(
                0, t_num // BLK, body, jnp.ones((s, 128), jnp.bool_)
            )
            pos = segment_positions(s) + gi * seg
            valid = jnp.logical_and(acc, pos < end)
            w = valid.reshape(s // 32, 32, 128).astype(jnp.uint32)
            shifts = jnp.arange(32, dtype=jnp.uint32)[None, :, None]
            return jnp.sum(w << shifts, axis=1, dtype=jnp.uint32)

        words = jax.lax.map(one_seg, (pw, jnp.arange(g, dtype=jnp.int32)))
        return bitmap_linear(words)

    lins = [
        chunk_bitmap(v, m, e)
        for (v, m), e in zip(uniq_tables, uniq_ends)
    ]
    acc = None
    for u, d in zip(chunk_map, word_shifts):
        t = lins[u]
        d = min(d, t.shape[0])  # chunk wholly past the corpus -> all-zero
        if d:
            t = jnp.concatenate([t[d:], jnp.zeros((d,), jnp.uint32)])
        acc = t if acc is None else (acc & t)
    count = jnp.sum(jax.lax.population_count(acc).astype(jnp.int32))
    # first set bit: lowest bit of the first nonzero word.
    lw = acc.shape[0]
    low = acc & (jnp.uint32(0) - acc)
    ctz = jax.lax.population_count(low - jnp.uint32(1)).astype(jnp.int32)
    pos = 32 * jnp.arange(lw, dtype=jnp.int32) + ctz
    first = jnp.min(jnp.where(acc != jnp.uint32(0), pos, SENTINEL))
    return count, first, bitmap_from_linear(acc, g, s // 32)


def chained_match_bitmap(pw, uniq_tables, uniq_lens, chunk_map, offsets,
                         hay_len: int, s: int):
    """Combined match bitmap of a chunked needle over the tiled layout.

    ``pw``: the layout's packed uint32 windows (DeviceHaystack.windows());
    ``uniq_tables``: [(values uint32[T_u], masks uint32[T_u])] per unique
    chunk; ``uniq_lens``: byte length of each unique chunk; ``chunk_map[j]``:
    which unique table chunk ``j`` uses; ``offsets[j]``: its byte offset in
    the needle (must be multiples of 32).  Returns device
    ``(count int32, first int32 (SENTINEL absent), words uint32[G,S/32,128])``
    — the last chunk's end bound enforces ``p <= hay_len - k`` exactly.
    """
    import numpy as np

    for o in offsets:
        if o % 32:
            raise ValueError(f"chunk offset {o} not a multiple of 32")
    # Pad each table to the impl's probe-block multiple with mask-0 slots
    # (mask 0 -> trivially true) so the block loop needs no remainder arm.
    BLK = 8

    def _pad(a):
        a = np.asarray(a, np.uint32)
        r = (-len(a)) % BLK
        return np.pad(a, ((0, r),))

    uniq = tuple(
        (jnp.asarray(_pad(v)), jnp.asarray(_pad(m)))
        for v, m in uniq_tables
    )
    ends = tuple(
        jnp.asarray(max(hay_len - int(L) + 1, 0), jnp.int32)
        for L in uniq_lens
    )
    return _chained_bitmap_impl(
        pw, uniq, ends, tuple(chunk_map), tuple(o // 32 for o in offsets), s
    )
