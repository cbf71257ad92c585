"""Shared scan math used by both the Pallas kernels and the XLA fallback path.

Single source of truth for the packed-window probe evaluation (the device
re-expression of the reference's cmpeq+and+movemask filter and memcmp verify,
src/lib.rs:199-251), used by the plain jitted XLA paths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: "no match" sentinel for first-offset reductions (int32 max).
SENTINEL = 2**31 - 1

LANES = 128


def packed_windows(tile_u8: jax.Array) -> jax.Array:
    """uint8[(H, L)] -> uint32[(H-3, L)] of little-endian 4-byte windows.

    ``P[s, c] = b[s,c] | b[s+1,c]<<8 | b[s+2,c]<<16 | b[s+3,c]<<24`` — the
    4-byte window starting at each flat position, built from 3 row-shifted
    ORs so the haystack is read from device memory once per pass.
    """
    b = tile_u8.astype(jnp.uint32)
    h = b.shape[0]
    return (
        b[0 : h - 3]
        | (b[1 : h - 2] << 8)
        | (b[2 : h - 1] << 16)
        | (b[3 : h] << 24)
    )


def probe_acc(slicer, probes):
    """AND together probe compares over the result rows.

    ``slicer(offset) -> uint32[(s, LANES)]`` extracts the packed windows
    starting ``offset`` rows in (a value dynamic-slice in XLA, a ``pl.ds`` ref
    slice inside a Pallas kernel); ``probes``: sequence of (offset, value,
    mask) traced or static scalars.  Returns bool[(s, LANES)].

    A probe with mask == 0 (and value 0) is trivially true, which is how
    batched tables evaluate needles of mixed lengths in one fixed-shape
    kernel.  CONTRACT: values are pre-masked (``val & mask == val``, enforced
    by needle.build_probe_table / probe_program) so the compare is the 2-op
    ``(w & m) == v`` form rather than 3-op ``((w ^ v) & m) == 0``.
    """
    acc = None
    for off, val, mask in probes:
        eq = (slicer(off) & mask) == val
        acc = eq if acc is None else jnp.logical_and(acc, eq)
    return acc


def value_slicer(p_windows, s: int):
    """Slicer over a materialized packed-window value (XLA path)."""
    return lambda off: jax.lax.dynamic_slice_in_dim(p_windows, off, s, axis=0)


def segment_positions(s: int) -> jax.Array:
    """int32[(s, LANES)]: flat in-segment position of (row, lane) = lane*s+row."""
    row = jax.lax.broadcasted_iota(jnp.int32, (s, LANES), 0)
    lane = jax.lax.broadcasted_iota(jnp.int32, (s, LANES), 1)
    return lane * s + row


def first_offset(match, end_local, s: int, row0=0) -> jax.Array:
    """Min valid matching in-segment position, or SENTINEL.

    ``end_local`` = (global end) - (segment base); positions >= end_local are
    masked — the analogue of the reference's ``end = len - k + 1`` bound and
    tail lane mask (src/lib.rs:258, :276-283), done by iota compare instead of
    overlapping reads.  ``match`` may be a row-chunk of the segment starting
    at row ``row0``; ``s`` is always the full column stride.
    """
    rows = match.shape[0]
    row = jax.lax.broadcasted_iota(jnp.int32, (rows, LANES), 0)
    lane = jax.lax.broadcasted_iota(jnp.int32, (rows, LANES), 1)
    pos = lane * s + row + row0
    valid = jnp.logical_and(match, pos < end_local)
    return jnp.min(jnp.where(valid, pos, SENTINEL))
