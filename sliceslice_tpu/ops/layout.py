"""Haystack device layout: column-major byte tiles with halo rows.

The reference streams 32-byte SIMD registers over the haystack with a second
load offset by ``position`` and a masked overlapping tail (src/lib.rs:253-287).
The device re-expression: lay the byte stream out **column-major** over 128
lanes so that a shift of the flat stream becomes a *row shift* — a probe at
byte offset ``4t`` reads the same lane ``4t`` rows further down, and a row of
128 lanes is one contiguous 512-byte load of packed windows:

    cols[g, s, c] = hay[g*SEG + c*S + s]          (SEG = S * 128)

A window starting at flat position ``p = g*SEG + c*S + s`` occupies rows
``s .. s+k-1`` of column ``c`` — so ``KH = k_max - 1`` extra *halo rows* are
appended per segment, where ``cols[g, S+t, c] = hay[g*SEG + (c+1)*S + t]``
(the first rows of the next column; for the last column, the first bytes of
the next segment).  This plays the role of the reference's overlapping
``start + position`` load and its masked tail (src/lib.rs:276-283): instead of
re-loading a full register at ``end - LANES`` with a lane mask, every position
is evaluated exactly once and invalid positions (``p > len - k``) are masked
with an iota compare — masking instead of overlapping reads, same semantics
(``end = len - k + 1``, src/lib.rs:258).

Segments are self-contained (halo included), which makes multi-device
sharding embarrassingly parallel: shard the ``g`` axis, no neighbor
communication.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

LANES = 128
#: Minimum halo rows: the packed-window build reads bytes ``s .. s+3``.
MIN_KH = 3
#: Default halo supports needles up to 64 bytes without relayout.
DEFAULT_KH = 64
#: Max rows per segment (4096 rows * 128 lanes = 512 KiB): the grain of
#: the find kernel's early exit and of the XLA paths' per-segment steps.
SEG_CAP_ROWS = 4096
#: Haystacks at or below this many bytes use the flat (non-tiled) XLA path.
SHORT_HAY_BYTES = 8192

#: A single device layout must keep every position (including trailing pad)
#: inside int32 — the kernels' offset math and SENTINEL live there.  Larger
#: corpora stream (utils/streaming.py, int64 host fold) or shard
#: (parallel/shard_scan.py, per-shard local int32 + int64 combine).
MAX_DEVICE_POSITIONS = 2**31 - 1


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def plan_layout(length: int, kh: int) -> tuple[int, int]:
    """Pick (segment_rows S, num_segments G) for a haystack of ``length`` bytes.

    S is bucketed (powers of two of rows for small haystacks, multiples of 512
    for large ones, always a multiple of 32 — the packed-bitmap word height
    and a multiple of the kernels' row tile) so distinct haystack lengths
    share compiled kernels — the
    analogue of the reference's haystack-length vector ladder
    (src/x86.rs:361-375) with buckets instead of register widths.  Large
    haystacks use balanced segments so trailing-pad waste stays small.
    """
    kh_rows = round_up(max(kh, MIN_KH), 32)
    if length <= 64 * 1024:
        rows = max(32, -(-length // LANES))
        s = max(32 * next_pow2(-(-rows // 32)), kh_rows)
        return min(s, SEG_CAP_ROWS), 1
    # Multi-segment: small segments give the kernels' early exit fine
    # granularity (a skipped segment costs zero), but each segment costs a
    # step — so cap the segment count at ~64 and let segments grow with the
    # corpus (512 rows up to ~4 MiB, then larger, up to SEG_CAP_ROWS).
    s = 512
    while length > 64 * (s * LANES) and s < SEG_CAP_ROWS:
        s *= 2
    s = max(s, kh_rows)
    g = max(1, -(-length // (s * LANES)))
    return s, g


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _build_cols(padded: jax.Array, g: int, s: int, kh: int) -> jax.Array:
    """padded: uint8[(g*s*LANES + kh,)] -> cols uint8[(g, s+kh, LANES)]."""
    seg = s * LANES
    base = padded[: g * seg].reshape(g, LANES, s).transpose(0, 2, 1)
    halo = jnp.roll(base[:, :kh, :], -1, axis=2)
    ext_idx = (jnp.arange(g)[:, None] + 1) * seg + jnp.arange(kh)[None, :]
    ext = padded[ext_idx]  # (g, kh)
    halo = halo.at[:, :, -1].set(ext)
    return jnp.concatenate([base, halo], axis=1)


@functools.partial(jax.jit, static_argnums=(1,))
def _pad_flat(arr: jax.Array, lp: int) -> jax.Array:
    return jnp.pad(arr, (0, lp - arr.shape[0]))


@jax.jit
def _pack_all(cols: jax.Array) -> jax.Array:
    """cols uint8 (g, h, LANES) -> packed windows uint32 (g, h-3, LANES)."""
    from .scan_math import packed_windows

    return jax.vmap(packed_windows)(cols)


@dataclasses.dataclass
class DeviceHaystack:
    """A haystack resident on device, preprocessed once and searched many times
    (the analogue of the reference's mmap-once-scan-often usage,
    examples/grep.rs:49-50).

    ``cols`` is the tiled layout for the Pallas scan kernels (None for short
    haystacks); ``flat`` is a zero-padded 1-D uint8 copy for the XLA path.
    """

    length: int
    kh: int
    s: int
    g: int
    cols: Optional[jax.Array]  # uint8 (g, s+kh, LANES) or None
    flat: Optional[jax.Array]  # uint8 (padded_len,) or None
    host_bytes: Optional[bytes] = None
    #: packed 4-byte little-endian windows, uint32 (g, s+kh-3, LANES) —
    #: precomputed once so the scan kernels DMA ready-to-probe windows
    #: instead of rebuilding them per (needle-block, segment) (4x the u8
    #: bytes in HBM; the scan is compute-bound, the DMA hides behind it).
    pw: Optional[jax.Array] = None
    #: one-slot cache for ensure_halo rebuilds: repeated calls (e.g. a
    #: searcher's per-sweep layout check) reuse one widened layout instead
    #: of re-preprocessing the corpus per call (which would also defeat
    #: downstream pw-identity caches).
    _rehalo: Optional["DeviceHaystack"] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def seg_bytes(self) -> int:
        return self.s * LANES

    @property
    def tiled(self) -> bool:
        """True for the tiled (segmented) layout, False for the flat
        short-haystack layout — independent of whether ``cols`` is currently
        materialized (see :meth:`drop_cols`)."""
        return self.s > 0

    def require_cols(self) -> jax.Array:
        """The uint8 byte tiles, rebuilding them from the host copy if they
        were dropped (:meth:`drop_cols` / ``preprocess(windows_only=True)``).
        Only the positions/bitmap and memchr paths read raw byte tiles; the
        find/count kernels consume the packed windows."""
        if self.cols is not None:
            return self.cols
        if not self.tiled:
            raise ValueError("flat layout has no cols")
        if self.host_bytes is None:
            raise ValueError(
                "byte tiles were dropped (windows_only layout) and no host "
                "bytes were retained to rebuild them; preprocess with "
                "keep_host=True for positions/memchr use"
            )
        total = self.g * self.s * LANES + self.kh
        padded = np.zeros((total,), dtype=np.uint8)
        padded[: self.length] = np.frombuffer(self.host_bytes, dtype=np.uint8)
        self.cols = _build_cols(jnp.asarray(padded), self.g, self.s, self.kh)
        return self.cols

    def drop_cols(self) -> "DeviceHaystack":
        """Free the uint8 byte tiles, keeping only the packed windows —
        find/count-only workloads then pin ~4/5 of the dual-layout HBM
        footprint instead of all of it (positions/memchr lazily rebuild via
        :meth:`require_cols` when host bytes were kept)."""
        if self.tiled:
            self.windows()  # make sure pw exists before freeing its source
            self.cols = None
        return self

    def supports_needle_len(self, k: int) -> bool:
        from ..needle import needed_halo

        return needed_halo(k) <= self.kh

    def ensure_halo(self, min_kh: int) -> "DeviceHaystack":
        """Return a layout with at least ``min_kh`` halo bytes — this one
        when it suffices, else a rebuilt layout (cached on this object, so
        repeated sweeps reuse ONE widened layout and its packed windows)
        preserving the windows-only choice."""
        if not self.tiled or self.kh >= min_kh:
            return self
        if self._rehalo is not None and self._rehalo.kh >= min_kh:
            return self._rehalo
        if self.host_bytes is None:
            raise ValueError(
                f"layout halo kh={self.kh} < required {min_kh} and no host "
                "bytes retained to rebuild; preprocess with a larger kh"
            )
        self._rehalo = preprocess(
            self.host_bytes, kh=min_kh,
            windows_only=self.cols is None and self.pw is not None,
        )
        return self._rehalo

    def ensure_kh(self, k: int) -> "DeviceHaystack":
        """Return a layout whose halo supports needles of length ``k``."""
        from ..needle import needed_halo

        return self.ensure_halo(needed_halo(k))

    def windows(self) -> jax.Array:
        """Packed uint32 windows (g, s+kh-3, LANES), built once and cached."""
        if self.pw is None:
            if not self.tiled:
                raise ValueError("flat layout has no tiled windows")
            self.pw = _pack_all(self.require_cols())
        return self.pw


def preprocess(
    hay: Union[bytes, bytearray, memoryview, np.ndarray],
    kh: int = DEFAULT_KH,
    keep_host: bool = True,
    force_cols: bool = False,
    seg_rows: Optional[int] = None,
    windows_only: bool = False,
    length: Optional[int] = None,
    zero_copy: bool = False,
) -> DeviceHaystack:
    """Build the device layout for a haystack. O(len) once, amortized over all
    subsequent searches.

    ``windows_only``: drop the uint8 byte tiles after deriving the packed
    windows — find/count-only workloads then hold ~4 bytes/corpus-byte on
    device instead of ~5, raising the max device-resident corpus (positions/memchr
    rebuild tiles lazily from the host copy when ``keep_host``).

    ``length``: logical corpus length when ``hay`` is an ndarray LONGER
    than it — the caller pre-padded the buffer with zeros (streaming's
    fixed-shape windows).

    ``zero_copy``: skip the defensive snapshot of an ndarray input.  On
    some backends (CPU) ``device_put`` aliases host memory, so the caller
    must then NEVER mutate the buffer while this layout is alive —
    streaming's pooled loop guarantees that by retiring buffers only
    after the derived arrays materialize.  With the buffer length equal
    to the layout's padded total this makes the upload fully copy-free
    host-side."""
    if isinstance(hay, np.ndarray):
        if hay.dtype != np.uint8:
            raise TypeError(f"haystack ndarray must be uint8, got {hay.dtype}")
        arr = hay
        data = None
        length = arr.size if length is None else int(length)
        if length > arr.size:
            raise ValueError(
                f"length={length} exceeds the {arr.size}-byte buffer"
            )
        if not zero_copy:
            # Snapshot: device_put may alias host memory (CPU backend), and
            # the pre-r5 contract let callers reuse their buffer freely.
            arr = np.array(arr, copy=True)
    else:
        data = bytes(hay)
        if length is not None and length != len(data):
            raise ValueError("length only applies to pre-padded ndarrays")
        length = len(data)
        arr = np.frombuffer(data, dtype=np.uint8)
    kh = round_up(max(kh, MIN_KH), 32)

    def host_copy():
        if data is not None:
            return data
        return arr[:length].tobytes()

    if length <= SHORT_HAY_BYTES and not force_cols:
        lp = max(128, next_pow2(length))
        flat = _pad_flat(jnp.asarray(arr[:length]), lp)
        return DeviceHaystack(
            length=length, kh=kh, s=0, g=0, cols=None, flat=flat,
            host_bytes=host_copy() if keep_host else None,
        )

    if seg_rows is not None:
        # Explicit segment size (sharding tests / dryruns): multiple of 32,
        # large enough for the halo.
        s = max(round_up(seg_rows, 32), round_up(max(kh, MIN_KH), 32))
        g = max(1, -(-length // (s * LANES)))
    else:
        s, g = plan_layout(length, kh)
    if g * s * LANES > MAX_DEVICE_POSITIONS:
        raise ValueError(
            f"haystack of {length} bytes exceeds the int32 position range of "
            "a single device layout; use utils.streaming.StreamingScanner or "
            "a sharded multi-host corpus (parallel/)"
        )
    total = g * s * LANES + kh
    if arr.size == total:
        # Pre-padded buffer at exactly the layout total: upload as-is
        # (caller guarantees bytes past ``length`` are zero).
        padded = arr
    else:
        padded = np.zeros((total,), dtype=np.uint8)
        padded[:length] = arr[:length]
    cols = _build_cols(jnp.asarray(padded), g, s, kh)
    dh = DeviceHaystack(
        length=length, kh=kh, s=s, g=g, cols=cols, flat=None,
        host_bytes=host_copy() if keep_host else None,
    )
    dh.windows()  # eager: part of the preprocess-once cost
    if windows_only:
        dh.drop_cols()
    return dh


def padded_total(length: int, kh: int, force_cols: bool = False) -> int:
    """Host buffer size whose ndarray rides :func:`preprocess`'s zero-copy
    pre-padded path for a corpus of ``length`` bytes: the tiled layout's
    ``g*s*LANES + kh`` total (or ``length`` itself for the flat
    short-haystack path, which never repacks)."""
    kh_r = round_up(max(kh, MIN_KH), 32)
    if length <= SHORT_HAY_BYTES and not force_cols:
        return length
    s, g = plan_layout(length, kh_r)
    return g * s * LANES + kh_r


def position_grid(s: int) -> np.ndarray:
    """int32[(s, LANES)] of flat in-segment positions: ``pos = lane*s + row``
    (segment g adds ``g * s * LANES``).  The layout's position convention in
    one place; kernels compute the same thing with broadcasted iotas."""
    rows = np.arange(s, dtype=np.int32)[:, None]
    lanes = np.arange(LANES, dtype=np.int32)[None, :]
    return lanes * s + rows
