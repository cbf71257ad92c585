"""Pallas scan kernels for the tiled layout, compiled through Triton.

These kernels play the role of the reference's SIMD intrinsic layers
(src/x86.rs:26-235, src/aarch64.rs:27-174, src/wasm32.rs:7-178) plus the
generic kernel they feed (``vector_search_in_chunk``/``vector_search_in``,
src/lib.rs:199-287):

* the haystack is laid out column-major over 128 lanes (ops/layout.py) with
  its 4-byte little-endian windows packed once at preprocess time, so a
  probe slot ``t`` reads the window ``4*t`` rows further down the same
  lane — ``ceil(k/4)`` masked uint32 compares prove an exact match with no
  data-dependent control flow;
* a program owns :data:`NEEDLE_BLOCK` needles and one split of the
  corpus's segments.  It loads each ``(ROWS, 128)`` window tile once and
  compares it against all of its needles in registers, keeping a running
  per-position minimum that is reduced once per segment;
* the grid is (needle blocks, corpus splits).  Blocks run in parallel and
  in no set order, so the first-match minimum across splits is an
  ``atomic_min`` on the output.  The same atomic doubles as the early exit
  (the reference's first-match return, src/lib.rs:242-244, at segment
  grain): before each segment a program reads the published minima of its
  needles and stops once every one already has a match before that
  segment.  The launch order is split-major, so later splits mostly find
  their needles settled and leave at once;
* invalid positions are masked by the caller's ``ends`` (``end = len - k +
  1``, src/lib.rs:258) after the kernel: the first raw match is the first
  valid one iff it lies below ``end``.

Outputs are per-needle first-match offsets (int32, SENTINEL when absent) —
a strict superset of the reference's bool ``search_in``.  The count kernel
shares the grid and tiles but has no early exit: each split writes its
partial counts and XLA sums them.  Both beat their plain XLA formulations
(``xla_backend.find_batched_cols`` / ``count_batched_cols``, the
differential references) on the H100; the 1-byte memchr rung did not and
is plain XLA (PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import config
from .scan_math import SENTINEL

LANES = 128

#: Needles per program: each window tile is compared against all of them
#: while it sits in registers.
NEEDLE_BLOCK = 8

#: Rows per inner step: one (ROWS, 128) uint32 window tile per probe slot.
ROWS = 8

#: Programs one launch aims for (several per SM of a 132-SM card).  A
#: launch with fewer needle blocks splits the corpus's segments to get
#: there; more splits only cost an early-exit check each.
TARGET_PROGRAMS = 1024

#: Probe tables up to this width are unrolled; wider (long-needle) tables
#: loop over their slots, bounding compile time and code size.
UNROLL_T = 16

_PARAMS = plgpu.CompilerParams(num_warps=4, num_stages=2)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_block(n: int, shards: int = 1) -> int:
    """Padded table rows for ``n`` needles split over ``shards`` needle
    shards: a multiple of ``NEEDLE_BLOCK * shards``.  The one needle-block
    plan, shared by the pre-padded device tables of models/batched.py and
    the sharded scanner (so the hot path issues no padding dispatches)."""
    return _round_up(max(n, 1), NEEDLE_BLOCK * shards)


def _probe_chain(vt_ref, mt_ref, pw_ref, blk, t: int):
    """``match(gi, r0) -> bool (NEEDLE_BLOCK, ROWS, 128)``: the block's
    probe chain over window rows ``r0 .. r0 + ROWS`` of segment ``gi``.
    Slot ``ti`` compares the window ``4 * ti`` rows further down the same
    lane under its mask; a mask-0 slot is trivially true."""

    def window(gi, r0, ti):
        return pw_ref[gi, pl.ds(r0 + 4 * ti, ROWS), :][None]

    if t <= UNROLL_T:
        vals = [vt_ref[ti, blk][:, None, None] for ti in range(t)]
        msks = [mt_ref[ti, blk][:, None, None] for ti in range(t)]

        def match(gi, r0):
            acc = None
            for ti in range(t):
                eq = (window(gi, r0, ti) & msks[ti]) == vals[ti]
                acc = eq if acc is None else jnp.logical_and(acc, eq)
            return acc

        return match

    def match(gi, r0):
        def slot(ti, acc):
            v = vt_ref[ti, blk][:, None, None]
            m = mt_ref[ti, blk][:, None, None]
            return jnp.logical_and(acc, (window(gi, r0, ti) & m) == v)

        return jax.lax.fori_loop(
            0, t, slot, jnp.ones((NEEDLE_BLOCK, ROWS, LANES), jnp.bool_)
        )

    return match


def plan_splits(n_blocks: int, g: int) -> int:
    """Corpus splits for a launch of ``n_blocks`` needle blocks over ``g``
    segments."""
    return max(1, min(g, -(-TARGET_PROGRAMS // max(n_blocks, 1))))


@functools.lru_cache(maxsize=256)
def _find_call(g: int, rows: int, s: int, t: int, n_pad: int,
               n_splits: int, interpret: bool):
    """Bare find kernel: (values^T (t, n_pad) u32, masks^T (t, n_pad) u32,
    pw (g, rows, 128) u32, init (n_pad,) i32 = SENTINEL) -> raw first-match
    offsets (n_pad,) i32, relative to the layout's first byte, ``ends`` not
    yet applied.  Mask-0 rows (table padding) match at offset 0."""
    nb = NEEDLE_BLOCK
    seg = s * LANES
    gps = -(-g // n_splits)
    n_chunks = s // ROWS

    def kernel(vt_ref, mt_ref, pw_ref, init_ref, out_ref):
        del init_ref  # aliased to out_ref: the SENTINEL-filled minima
        blk = pl.ds(pl.program_id(0) * nb, nb)
        g_lo = pl.program_id(1) * gps
        g_hi = jnp.minimum(g_lo + gps, g)
        match = _probe_chain(vt_ref, mt_ref, pw_ref, blk, t)
        pos0 = (
            jax.lax.broadcasted_iota(jnp.int32, (ROWS, LANES), 1) * s
            + jax.lax.broadcasted_iota(jnp.int32, (ROWS, LANES), 0)
        )

        def settled(minima, gi):
            # Every needle of the block has a match before segment gi.
            return jnp.max(jnp.where(minima < gi * seg, 0, 1)) == 0

        def scan_segment(carry):
            gi, best, _ = carry

            def chunk(ci, mins):
                r0 = ci * ROWS
                hit = jnp.where(match(gi, r0), pos0 + r0, SENTINEL)
                return jnp.minimum(mins, hit)

            mins = jax.lax.fori_loop(
                0, n_chunks, chunk,
                jnp.full((nb, ROWS, LANES), SENTINEL, jnp.int32),
            )
            seg_min = jnp.min(jnp.min(mins, axis=2), axis=1)
            best = jnp.minimum(
                best, jnp.where(seg_min < SENTINEL, seg_min + gi * seg,
                                SENTINEL)
            )
            # Publish; the old value folds in what other splits found.
            glob = jnp.minimum(plgpu.atomic_min(out_ref, blk, best), best)
            return gi + 1, best, settled(glob, gi + 1)

        glob0 = plgpu.atomic_min(
            out_ref, blk, jnp.full((nb,), SENTINEL, jnp.int32)
        )
        jax.lax.while_loop(
            lambda c: jnp.logical_and(c[0] < g_hi, jnp.logical_not(c[2])),
            scan_segment,
            (g_lo, jnp.full((nb,), SENTINEL, jnp.int32), settled(glob0, g_lo)),
        )

    full = lambda *shape: pl.BlockSpec(shape, lambda b, sp: (0,) * len(shape))
    return pl.pallas_call(
        kernel,
        grid=(n_pad // nb, n_splits),
        in_specs=[
            full(t, n_pad), full(t, n_pad), full(g, rows, LANES), full(n_pad),
        ],
        out_specs=full(n_pad),
        out_shape=jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        input_output_aliases={3: 0},
        backend="triton",
        compiler_params=_PARAMS,
        interpret=interpret,
        name="sliceslice_find",
    )


@functools.lru_cache(maxsize=128)
def _count_call(g: int, rows: int, s: int, t: int, n_pad: int,
                n_splits: int, interpret: bool):
    """Count variant of :func:`_find_call` (same grid and tiles, no early
    exit): (values^T, masks^T, ends (n_pad,) i32, pw) -> per-split partial
    counts (n_splits, n_pad) i32 of matches at positions < ends."""
    nb = NEEDLE_BLOCK
    seg = s * LANES
    gps = -(-g // n_splits)
    n_chunks = s // ROWS

    def kernel(vt_ref, mt_ref, end_ref, pw_ref, out_ref):
        blk = pl.ds(pl.program_id(0) * nb, nb)
        sp = pl.program_id(1)
        g_lo = sp * gps
        g_hi = jnp.minimum(g_lo + gps, g)
        match = _probe_chain(vt_ref, mt_ref, pw_ref, blk, t)
        ends = end_ref[blk][:, None, None]
        pos0 = (
            jax.lax.broadcasted_iota(jnp.int32, (ROWS, LANES), 1) * s
            + jax.lax.broadcasted_iota(jnp.int32, (ROWS, LANES), 0)
        )

        def segment(gi, counts):
            def chunk(ci, counts):
                r0 = ci * ROWS
                valid = (pos0 + (gi * seg + r0))[None] < ends
                acc = jnp.logical_and(valid, match(gi, r0))
                return counts + acc.astype(jnp.int32)

            return jax.lax.fori_loop(0, n_chunks, chunk, counts)

        counts = jax.lax.fori_loop(
            g_lo, g_hi, segment, jnp.zeros((nb, ROWS, LANES), jnp.int32)
        )
        out_ref[sp, blk] = jnp.sum(jnp.sum(counts, axis=2), axis=1)

    full = lambda *shape: pl.BlockSpec(shape, lambda b, sp: (0,) * len(shape))
    return pl.pallas_call(
        kernel,
        grid=(n_pad // nb, n_splits),
        in_specs=[
            full(t, n_pad), full(t, n_pad), full(n_pad), full(g, rows, LANES),
        ],
        out_specs=full(n_splits, n_pad),
        out_shape=jax.ShapeDtypeStruct((n_splits, n_pad), jnp.int32),
        backend="triton",
        compiler_params=_PARAMS,
        interpret=interpret,
        name="sliceslice_count",
    )


def count_raw(values, masks, ends, pw, s: int):
    """Overlapping match counts (int32[n_pad]) at positions < ``ends`` of a
    pre-padded (n_pad, t) table over packed windows ``pw``.  Traceable,
    like :func:`find_raw`."""
    _check_shapes(values, pw, s)
    g, rows, _ = pw.shape
    n_pad, t = values.shape
    call = _count_call(
        g, rows, s, t, n_pad, plan_splits(n_pad // NEEDLE_BLOCK, g),
        config.use_interpret(),
    )
    return jnp.sum(call(values.T, masks.T, ends, pw), axis=0)


def _check_shapes(values, pw, s: int) -> None:
    g, rows, lanes = pw.shape
    assert lanes == LANES
    t = values.shape[1]
    # Probe slots must fit the layout halo: the last slot reads window
    # rows 4*(t-1) .. 4*(t-1) + s - 1 of each segment.
    assert 4 * (t - 1) + s <= rows, (
        f"probe table width {t} needs {4 * t - 1} halo bytes, layout has "
        f"{rows + 3 - s}"
    )
    assert values.shape[0] % NEEDLE_BLOCK == 0, "pad tables with plan_block"


def find_raw(values, masks, pw, s: int):
    """Raw first-match offsets (int32[n_pad], SENTINEL absent, ``ends`` not
    applied) of a pre-padded (n_pad, t) table over packed windows ``pw``
    (g, rows, 128).  Traceable: the sharded scanner calls it per shard
    inside ``shard_map``."""
    _check_shapes(values, pw, s)
    g, rows, _ = pw.shape
    n_pad, t = values.shape
    call = _find_call(
        g, rows, s, t, n_pad, plan_splits(n_pad // NEEDLE_BLOCK, g),
        config.use_interpret(),
    )
    return call(
        values.T, masks.T, pw, jnp.full((n_pad,), SENTINEL, jnp.int32)
    )


def _prepare(cols, values, masks, ends, pw):
    """Shared wrapper front: packed windows (built from ``cols`` when the
    caller has none), defensively re-masked host tables, and tables padded
    to the block plan (mask 0 and end 0 on padded rows: never reported)."""
    if pw is None:
        from .layout import _pack_all

        pw = _pack_all(cols)
    if isinstance(values, np.ndarray) and isinstance(masks, np.ndarray):
        values = values & masks
    n = values.shape[0]
    n_pad = plan_block(n)
    values = jnp.asarray(values, jnp.uint32)
    masks = jnp.asarray(masks, jnp.uint32)
    ends = jnp.asarray(ends, jnp.int32)
    if n_pad != n:
        pad = ((0, n_pad - n), (0, 0))
        values = jnp.pad(values, pad)
        masks = jnp.pad(masks, pad)
        ends = jnp.pad(ends, ((0, n_pad - n),))
    return pw, values, masks, ends, n


@functools.partial(jax.jit, static_argnums=(4, 5))
def _find_run(values, masks, ends, pw, s: int, n: int):
    first = find_raw(values, masks, pw, s)[:n]
    return jnp.where(first < ends[:n], first, SENTINEL)


def batched_find_cols(
    cols: jax.Array | None,
    values,
    masks,
    ends,
    s: int,
    pw: jax.Array | None = None,
) -> jax.Array:
    """First-match offsets (int32[N], SENTINEL when absent) of N needles over
    the tiled haystack — one fused device program.

    Every probe slot compares under its mask, so one table may mix needle
    widths (a mask-0 slot is trivially true).  CONTRACT: values are
    pre-masked (``v & m == v``); host ndarray tables are re-masked here
    defensively, and build_probe_table tables satisfy it by construction.
    Rows whose ``end`` is 0 never report a match.

    ``pw``: precomputed packed windows (``DeviceHaystack.windows()``);
    derived from ``cols`` when absent (one extra pass over the corpus — hot
    paths pass it)."""
    pw, values, masks, ends, n = _prepare(cols, values, masks, ends, pw)
    return _find_run(values, masks, ends, pw, s, n)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _count_run(values, masks, ends, pw, s: int, n: int):
    return count_raw(values, masks, ends, pw, s)[:n]


def batched_count_cols(
    cols: jax.Array | None,
    values,
    masks,
    ends,
    s: int,
    pw: jax.Array | None = None,
) -> jax.Array:
    """Count of OVERLAPPING occurrences (int32[N]) of N needles over the
    tiled haystack — capability extension over the reference's bool
    ``search_in`` (a count scans every position: no early exit).  Same
    table contract and ``pw`` handling as :func:`batched_find_cols`."""
    pw, values, masks, ends, n = _prepare(cols, values, masks, ends, pw)
    return _count_run(values, masks, ends, pw, s, n)


def memchr_find_cols(cols: jax.Array, byte: int, end: int, s: int):
    """First offset of one byte over the tiled uint8 layout (SENTINEL when
    absent) — the ``MemchrSearcher`` analogue (reference
    src/lib.rs:119-142), plain XLA."""
    from . import xla_backend

    return xla_backend.memchr_cols(cols, byte, end, s)
