"""Streaming corpus scanner — arbitrarily long byte streams through a
bounded device footprint.

The reference's long-sequence mechanism is its streaming register loop
(SURVEY.md §5.7); scaled up a level, this module streams *windows* of a file
(or chunk iterator) through the tiled scan kernel: each window carries a
``k_max - 1``-byte overlap peek so windows are self-contained, and
per-window ends mask the overlap region (counted exactly once, in the
window where a match's first byte lives — the same exactly-once rule as
shard boundaries).  Window results fold into an int64 host accumulator
every ``check_every`` windows (bounded retained device buffers, no
per-window sync; early stop checks the same fold).

Device math is window-LOCAL int32 (each window is far below 2 GiB); the
global offset is folded on host in int64, so streams of any length — well
past the 2 GiB int32 range — report exact first-match offsets (the
reference is offset-size agnostic via usize, src/lib.rs:253-287).

Two properties keep the hot stream free of per-window host overheads:
every window — including the stream's final short one — is zero-padded to
ONE fixed layout shape (``_wcap``), so the whole stream runs through
kernels :meth:`StreamingScanner.warmup` compiled up front (no mid-stream
compile); and each window issues ONE fused jit program (group kernels +
input-order scatter + device fold — the streaming analogue of the batched
``_sweep_fn``), with the full-window ``ends`` constants and the scatter
order resident on device once per stream instead of re-uploaded per
window.  Per-window wall/read/prep/dispatch/drain times are accumulated
in :attr:`StreamingScanner.stats` so a slow stream is self-attributing.

All three query modes run over streams: ``find`` (first offset, early
stop), ``count`` (overlapping totals), and ``positions`` (every offset —
the streamed ``find_iter`` capability; per-window packed bitmaps decoded
on host with the window's int64 base).  Needles of ANY length are
accepted, matching the reference's no-limit contract (src/lib.rs:52-59):
needles beyond the kernels' probe-table budget take the filter+verify
fallback (models/huge.py) against each window's host bytes — the overlap
then covers the full needle, so every match is contained in the window
where it starts.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Iterable, Iterator, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.batched import BatchedSearcher
from ..ops import scan_kernel
from ..ops.layout import preprocess
from ..ops.scan_math import SENTINEL
from ..ops.xla_backend import SPARSE_POSITIONS_CAP


class _IngestStopped(Exception):
    """Raised inside a window source when the stream shut down early
    (buffer pool drained on purpose); never escapes _ingest."""


def _file_windows(
    path, window: int, overlap: int, bufsize: int, start: int = 0,
    alloc=None,
) -> Iterator[Tuple[np.ndarray, int, bool]]:
    """Yield ``(buffer, window_len, is_last)`` — the window's bytes read
    DIRECTLY into a fresh zero-padded ``bufsize`` buffer (one copy from
    the page cache; the buffer is layout-total-sized so the device upload
    is zero-copy, see layout.preprocess ``length``).  ``is_last`` must be
    computed from the file size, NOT from a short read: a window whose
    remaining bytes fall in (window, window + overlap) short-reads yet is
    followed by one more window — inferring finality from length would
    lift the exactly-once clamp there and double-count overlap-region
    matches."""
    size = os.path.getsize(path)
    span = window + overlap
    with open(path, "rb") as f:
        base = start
        while base < size:
            f.seek(base)
            buf = alloc() if alloc is not None else np.zeros(
                (bufsize,), np.uint8
            )
            want = min(span, size - base)
            got = int(f.readinto(memoryview(buf)[:want]) or 0)
            if alloc is not None:
                buf[got:] = 0  # recycled buffer: clear the stale tail
            yield buf, got, base + window >= size
            base += window


def _chunk_windows(
    chunks: Iterable[bytes], window: int, overlap: int, bufsize: int,
    alloc=None,
) -> Iterator[Tuple[np.ndarray, int, bool]]:
    """Re-chunk an arbitrary byte-chunk iterator into overlapping windows,
    yielding ``(buffer, window_len, is_last)`` (fresh zero-padded
    layout-total buffers, as :func:`_file_windows`).  Amortized O(stream)
    copying: append + in-place front deletion on a bytearray (a bytes
    buffer would re-copy the whole pending window per chunk — quadratic
    for small chunks).  Full windows are never final here: the while loop
    always keeps ``max(overlap, 1)`` trailing bytes behind, so the
    stream's true end is ALWAYS the final short yield — including
    ``overlap == 0`` (all needles length <= 1) with a stream length an
    exact multiple of ``window``, where a ``>=``-with-0 loop would consume
    the final window and mark it non-final."""

    def emit(view: bytes | bytearray, wlen: int, is_last: bool):
        if alloc is not None:
            out = alloc()
            out[wlen:] = 0  # recycled buffer: clear the stale tail
        else:
            out = np.zeros((bufsize,), np.uint8)
        out[:wlen] = np.frombuffer(memoryview(view)[:wlen], np.uint8)
        return out, wlen, is_last

    buf = bytearray()
    keep = max(overlap, 1)  # invariant: the final yield carries is_last
    for c in chunks:
        buf += c
        while len(buf) >= window + keep:
            yield emit(buf, window + overlap, False)
            del buf[:window]
    if buf:
        yield emit(buf, len(buf), True)


@jax.jit
def _count_fold64(hi, lo, c):
    """Two-limb uint32 device accumulator: exact mod-2^64 totals with NO
    device->host traffic per window — streamed folds stay on device and
    the stream reads back ONCE at the end."""
    c = c.astype(jnp.uint32)
    lo2 = lo + c
    carry = (lo2 < c).astype(jnp.uint32)
    return hi + carry, lo2


@jax.jit
def _first_fold(best_w, best_l, w_idx, local):
    """Lexicographic (window, local-offset) min, both int32 — windows
    arrive in stream order, so the smallest (window, local) pair IS the
    global first match; combined to int64 on host once at stream end."""
    cand_w = jnp.where(local < SENTINEL, w_idx, jnp.int32(SENTINEL))
    better = jnp.logical_or(
        cand_w < best_w,
        jnp.logical_and(cand_w == best_w, local < best_l),
    )
    return (
        jnp.where(better, cand_w, best_w),
        jnp.where(better, local, best_l),
    )


def _host_count_limited(data: bytes, nd: bytes, end: int) -> int:
    """Overlapping occurrences of ``nd`` starting at positions < ``end``."""
    c = 0
    p = data.find(nd)
    while 0 <= p < end:
        c += 1
        p = data.find(nd, p + 1)
    return c


def _host_positions_limited(data: bytes, nd: bytes, end: int) -> np.ndarray:
    """Overlapping match offsets of ``nd`` at positions < ``end``."""
    out = []
    p = data.find(nd)
    while 0 <= p < end:
        out.append(p)
        p = data.find(nd, p + 1)
    return np.asarray(out, dtype=np.int64)


class StreamingScanner:
    """Windowed scan of arbitrarily long byte streams.

    ``mesh``: optional device mesh — each window is then scanned by the
    sharded kernels (parallel/shard_scan.py), composing the two scale
    dimensions: streams beyond any single device's memory AND corpora
    beyond one chip's bandwidth (windows sharded over the data axis, the
    same exactly-once rules at both window and shard boundaries).

    ``window_bytes`` is raised to the overlap (longest needle - 1) when a
    needle exceeds it, bounding read amplification at 2x; huge needles
    (beyond MAX_NEEDLE_LEN) keep each window's host bytes for the verify
    step of their filter+verify path."""

    def __init__(
        self,
        needles: Sequence,
        window_bytes: int = 32 * 1024 * 1024,
        check_every: int = 4,
        mesh=None,
        prefetch: int = 2,
    ):
        self.batched = BatchedSearcher(needles)
        bs = self.batched
        k_all = max(
            [bs.max_len] + [hs.size for _, hs in bs._huge], default=0
        )
        self.overlap = max(k_all - 1, 0)
        # A needle longer than the window would otherwise make every window
        # mostly overlap; growing the window bounds re-read at <= 2x.
        self.window = max(window_bytes, self.overlap)
        #: fixed per-window device byte capacity: EVERY window — including
        #: the stream's final short one — is zero-padded to this length
        #: before layout, so the whole stream runs through ONE compiled
        #: kernel shape.  Padding is semantically free (per-window ``ends``
        #: bound valid positions to the true bytes) and removes the
        #: mid-stream recompile a short trailing window would trigger.
        self._wcap = self.window + self.overlap
        self.check_every = check_every
        self.mesh = mesh
        #: per-stream instrumentation (reset at each public call; read via
        #: :meth:`stats_summary`): accumulated read/prep/dispatch/drain
        #: seconds plus per-window wall latencies — a slow stream is
        #: self-attributing instead of prose-explained.
        self.stats: dict = {}
        self._stats_lock = threading.Lock()
        #: windows in flight beyond the one being scanned: read + host pad +
        #: device upload of window N+1 happen on a background thread while
        #: window N's scans dispatch (0 = fully serial ingestion).  Each
        #: in-flight window pins ~4-5 bytes/byte of HBM.
        self.prefetch = max(int(prefetch), 0)
        from ..needle import needed_halo_for_t

        self._kh = needed_halo_for_t(bs.max_t)
        if bs._huge:
            from ..models.huge import PREFIX_LEN

            # The huge-needle device filter probes a PREFIX_LEN-byte prefix.
            self._kh = max(self._kh, PREFIX_LEN - 1)
        if bs._huge:
            # ONE batched prefix-filter table over all huge needles: each
            # window runs a single count scan + a single readback for the
            # tier decisions, instead of one scan + readback per needle.
            from ..models.batched import _Group
            from ..models.huge import PREFIX_LEN as _PL

            self._huge_prefix_grp = _Group(
                np.arange(len(bs._huge), dtype=np.int64),
                [hs.needle.data for _, hs in bs._huge],
                16,
            )
            self._huge_slot = {
                i: k for k, (i, _) in enumerate(bs._huge)
            }
            self._huge_pref_ends = jnp.asarray(
                self._huge_prefix_grp.pad_ends(
                    np.full(
                        (len(bs._huge),),
                        max(self.window + self.overlap - _PL + 1, 0),
                        np.int32,
                    )
                )
            )
        else:
            self._huge_prefix_grp = None
        from ..ops.layout import SHORT_HAY_BYTES, padded_total

        #: window host buffers are allocated at the layout's padded total,
        #: so the main-thread device upload is zero-copy (no host repack).
        self._buf_total = max(
            padded_total(self._wcap, self._kh, force_cols=mesh is not None),
            self._wcap,
        )
        self._flat_mode = self._wcap <= SHORT_HAY_BYTES and mesh is None
        #: recycled window host buffers (see _ensure_pool / _ingest).
        self._pool_q = None
        if not self._flat_mode and mesh is None:
            from ..ops.layout import MIN_KH, plan_layout, round_up

            kh_r = round_up(max(self._kh, MIN_KH), 32)
            s_rows, g_segs = plan_layout(self._wcap, kh_r)
            #: (s, g, kh) of the fixed window layout — used to build
            #: DeviceHaystacks directly from pooled device uploads.
            self._geom = (s_rows, g_segs, kh_r)
        else:
            self._geom = None
        # Kernel-group slots: the per-window scatter zero-inits non-group
        # (huge) slots, so find folds must never read them as offset-0 hits.
        self._kernel_slot = np.zeros((len(bs),), dtype=bool)
        for grp in bs.groups:
            self._kernel_slot[grp.indices] = True
        # Hoisted per-group ends for FULL (non-final) windows: with the
        # fixed _wcap layout, every full window's valid-position bound is
        # exactly ``window`` for every needle (window >= overlap >= k - 1),
        # so these device arrays upload ONCE per scanner instead of once
        # per (group, window).
        self._ends_full_dev = tuple(
            jnp.asarray(grp.pad_ends(np.full((grp.n,), self.window,
                                             np.int32)))
            for grp in bs.groups
        )
        #: fused per-window jit programs, built lazily on the first tiled
        #: window (one layout shape per stream — see _wcap).
        self._step_cache: dict = {}

    # -- instrumentation ---------------------------------------------------

    def _reset_stats(self, mode: str) -> None:
        self.stats = {
            "mode": mode, "windows": 0, "bytes": 0, "read_s": 0.0,
            "prep_s": 0.0, "upload_s": 0.0, "dispatch_s": 0.0,
            "drain_s": 0.0, "window_ms": [],
        }

    def _stats_add(self, key: str, dt: float) -> None:
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0.0) + dt

    def stats_summary(self) -> dict:
        """Per-stream attribution of the LAST stream run: accumulated
        seconds in file read (including ``buf_wait_s``, the pool
        backpressure component — pure IO is their difference), window
        prep, upload + pool retirement, scan dispatch, and device drain,
        plus p50/p90 per-window wall latency.  Read/prep run on the
        prefetch thread when pipelining is on, so their sum can exceed
        the stream's wall time (overlap)."""
        s = dict(self.stats)
        wm = s.pop("window_ms", [])
        out = {k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in s.items()}
        if wm:
            q = np.percentile(np.asarray(wm), [50, 90])
            out["window_p50_ms"] = round(float(q[0]), 2)
            out["window_p90_ms"] = round(float(q[1]), 2)
        return out

    def _timed_windows(self, it: Iterator) -> Iterator:
        """Attribute time spent pulling from the raw window source (file
        read / chunk assembly) to ``read_s``."""
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                self._stats_add("read_s", time.perf_counter() - t0)
            yield item

    # -- window layout ---------------------------------------------------

    def _prep(self, buf: np.ndarray, need_cols: bool):
        """Per-window device layout from a pre-padded host buffer (window
        iterators allocate at the layout total with a zero tail).  Every
        window presents as the same fixed ``_wcap``-byte corpus, so the
        stream compiles exactly ONE kernel shape (per-window ``ends``
        clamp validity to the true bytes, so padding can never produce a
        counted match), and the upload is zero-copy off this buffer.
        Runs on the CONSUMER thread: the prefetch worker prepares host
        buffers only and never touches the device.  Huge needles keep
        the window's host bytes (their verify memcmps against them) and
        byte tiles (their prefix filter is the bitmap op); find/count-only
        kernel scans keep packed windows only (~4 bytes/byte on device
        instead of ~5)."""
        t0 = time.perf_counter()
        if isinstance(buf, jax.Array):
            dh = self._prep_from_device(buf, need_cols)
            self._stats_add("prep_s", time.perf_counter() - t0)
            return dh
        huge = bool(self.batched._huge)
        dh = preprocess(
            buf,
            kh=self._kh,
            keep_host=huge or self._flat_mode,
            windows_only=not (huge or need_cols),
            force_cols=self.mesh is not None,
            length=self._wcap,
            zero_copy=True,  # fresh per-window buffers, never reused
        )
        self._stats_add("prep_s", time.perf_counter() - t0)
        return dh

    def _prep_from_device(self, dev, need_cols: bool):
        """Layout from an already-uploaded pooled window buffer (the
        pooled hot tier; geometry fixed per scanner)."""
        from ..ops.layout import DeviceHaystack, _build_cols

        s_rows, g_segs, kh_r = self._geom
        cols = _build_cols(dev, g_segs, s_rows, kh_r)
        dh = DeviceHaystack(
            length=self._wcap, kh=kh_r, s=s_rows, g=g_segs, cols=cols,
            flat=None, host_bytes=None,
        )
        dh.windows()
        if not need_cols:
            dh.drop_cols()
        return dh

    def _end_h(self, k: int, wlen: int, is_last: bool) -> int:
        """Window-local valid-position bound for a length-``k`` needle:
        matches starting in the overlap peek belong to the next window,
        EXCEPT in the stream's final window, where the true end applies —
        a final window may be longer than ``window`` (a chunk stream
        shorter than window + overlap arrives as one window), so the
        clamp must be lifted there exactly as :meth:`_group_ends` does."""
        end = wlen - k + 1
        return end if is_last else min(self.window, end)

    # -- public API --------------------------------------------------------

    def find_in_file(
        self, path, early_stop: bool = True, start_offset: int = 0
    ) -> np.ndarray:
        """First-match offset per needle (int64[N], -1 absent) over the
        file's bytes from ``start_offset`` on; offsets are absolute file
        offsets (scan a tail / resume a partitioned scan)."""
        return self._scan(
            lambda alloc=None: _file_windows(
                path, self.window, self.overlap, self._buf_total,
                start_offset, alloc,
            ),
            early_stop,
            base0=start_offset,
        )

    def find_in_chunks(
        self,
        chunks: Iterable[bytes],
        early_stop: bool = True,
        start_offset: int = 0,
    ) -> np.ndarray:
        """``start_offset``: global offset of the stream's first byte —
        reported offsets are start_offset + stream position (resume /
        split-stream scans; int64 end to end, so offsets past 2^32 are
        exact through this public path)."""
        return self._scan(
            lambda alloc=None: _chunk_windows(
                chunks, self.window, self.overlap, self._buf_total, alloc
            ),
            early_stop,
            base0=start_offset,
        )

    def count_in_file(self, path, start_offset: int = 0) -> np.ndarray:
        """Overlapping occurrence counts (int64[N]) over the whole stream —
        exact past 2 GiB (per-window int32 device counts, int64 host sum).
        No early stop exists to use (counts need the full stream)."""
        return self._count(
            lambda alloc=None: _file_windows(
                path, self.window, self.overlap, self._buf_total,
                start_offset, alloc,
            )
        )

    def count_in_chunks(self, chunks: Iterable[bytes]) -> np.ndarray:
        return self._count(
            lambda alloc=None: _chunk_windows(
                chunks, self.window, self.overlap, self._buf_total, alloc
            )
        )

    def positions_in_file(self, path, start_offset: int = 0) -> list:
        """ALL (overlapping) match offsets per needle (int64[M] ascending,
        input order) — the streamed ``find_iter`` capability.  Per-window
        packed match bitmaps (window/8 bytes per needle), decoded on host
        with the window's int64 base, so offsets past 2 GiB are exact."""
        return self._positions(
            lambda alloc=None: _file_windows(
                path, self.window, self.overlap, self._buf_total,
                start_offset, alloc,
            ),
            base0=start_offset,
        )

    def positions_in_chunks(
        self, chunks: Iterable[bytes], start_offset: int = 0
    ) -> list:
        return self._positions(
            lambda alloc=None: _chunk_windows(
                chunks, self.window, self.overlap, self._buf_total, alloc
            ),
            base0=start_offset,
        )

    def warmup(
        self, modes: Sequence[str] = ("find", "count", "positions")
    ) -> "StreamingScanner":
        """Compile every kernel shape the stream will use: one synthetic
        window at the stream's fixed ``_wcap`` layout (EVERY real window —
        including the final short one — is padded to that same shape, see
        ``_prep``) runs through the fused find/count steps, the positions
        bitmap batches, and — when huge needles exist — their
        prefix-filter and dense chained-bitmap programs, blocked on
        device.  Performs one deliberate 32-byte readback up front (a
        first device->host transfer outside the timed stream); no RESULT
        data is ever read back.  Use before timed runs."""
        bs = self.batched
        need_cols = "positions" in modes or bool(bs._huge)
        np.asarray(jnp.zeros((8,), jnp.int32) + 1)
        if self.mesh is None and not self._flat_mode and not bs._huge:
            # Upload every pool buffer once now: the stream recycles
            # exactly these buffers, so first-upload costs of a host
            # buffer land here, outside the timed stream.
            free_q = self._ensure_pool()
            held = []
            try:
                while True:
                    held.append(free_q.get_nowait())
            except Exception:
                pass
            for b in held:
                jax.block_until_ready(jnp.asarray(b))
                free_q.put(b)
        dh = self._prep(
            np.zeros((self._buf_total,), np.uint8), need_cols=need_cols
        )
        wlen = self._wcap
        outs = []
        if bs.groups and self.mesh is not None:
            from ..parallel.shard_scan import (
                sharded_count_cols,
                sharded_find_cols,
            )

            for grp in bs.groups:
                ends = self._group_ends(grp, wlen, False)
                if "find" in modes:
                    outs.append(
                        sharded_find_cols(
                            dh, grp.values_dev, grp.masks_dev, ends,
                            self.mesh,
                        )
                    )
                if "count" in modes:
                    outs.append(
                        sharded_count_cols(
                            dh, grp.values_dev, grp.masks_dev, ends,
                            self.mesh,
                        )
                    )
        elif bs.groups and not dh.tiled:
            from ..ops import xla_backend

            for grp in bs.groups:
                ends = self._group_ends(grp, wlen, False)
                outs.append(
                    xla_backend.find_batched_flat(
                        dh.flat, grp.values_dev, grp.masks_dev,
                        jnp.asarray(ends.astype(np.int32)),
                    )
                )
        elif bs.groups:
            ends = self._window_ends_dev(wlen, False)
            tables = self._group_tables(ends)
            if "find" in modes:
                outs.extend(
                    self._find_step_fn(dh)(
                        dh.windows(), bs._order_dev, tables,
                        jnp.int32(0),
                        jnp.full((len(bs),), SENTINEL, jnp.int32),
                        jnp.full((len(bs),), SENTINEL, jnp.int32),
                    )
                )
            if "count" in modes:
                outs.extend(
                    self._count_step_fn(dh)(
                        dh.windows(), bs._order_dev, tables,
                        jnp.zeros((len(bs),), jnp.uint32),
                        jnp.zeros((len(bs),), jnp.uint32),
                    )
                )
            if "positions" in modes:
                from ..ops import xla_backend

                cols = dh.require_cols()
                for grp in bs.groups:
                    e = self._group_ends(grp, wlen, False)[: grp.n]
                    # The positions loop slices 16-needle batches; compile
                    # the full-batch shape and the distinct tail shape,
                    # for BOTH tiers (the sparse compact scan and the
                    # dense bitmap fallback — a dense needle mid-stream
                    # must not pay a compile).
                    batch = 16
                    spans = {min(batch, grp.n)}
                    if grp.n > batch and grp.n % batch:
                        spans.add(grp.n % batch)
                    for sp in spans:
                        outs.extend(
                            xla_backend.compact_positions_batched(
                                cols, grp.values_host[:sp],
                                grp.masks_host[:sp],
                                np.asarray(e[:sp], np.int32), dh.s,
                                self.sparse_cap,
                            )
                        )
                        outs.append(
                            xla_backend.match_bitmap_batched(
                                cols, grp.values_host[:sp],
                                grp.masks_host[:sp],
                                np.asarray(e[:sp], np.int32), dh.s,
                            )
                        )
        # Huge needles: compile the per-window device programs their
        # tiered path dispatches (the prefix-filter count/bitmap and the
        # dense chained-bitmap verify) so a first huge stream pays no
        # mid-stream compile.  The tier DECISION itself reads one
        # scalar per window at stream time (inherent to the design).
        if bs._huge and dh.tiled:
            from ..needle import probe_program
            from ..ops import xla_backend

            from ..models.huge import HOST_VERIFY_MAX

            # Batched per-window prefix filter (one scan for all huge
            # needles — what the streams dispatch).
            grp = self._huge_prefix_grp
            outs.append(
                scan_kernel.batched_count_cols(
                    None, grp.values_dev, grp.masks_dev,
                    self._huge_pref_ends, s=dh.s, pw=dh.windows(),
                )
            )
            for _, hs in bs._huge:
                pk = hs.needle.size
                values, masks = probe_program(hs.needle.data)
                # Sparse-tier candidate decode (compact scan — what
                # _host_candidates dispatches).
                outs.extend(
                    xla_backend.compact_positions(
                        dh.require_cols(), values, masks,
                        dh.length - pk + 1, dh.s, HOST_VERIFY_MAX,
                    )
                )
                (cnt, first, words), _dh2 = hs._dense(dh)
                outs.extend((cnt, first, words))
        for o in outs:
            jax.block_until_ready(o)
        return self

    # -- internals ---------------------------------------------------------

    def _ingest(self, factory, need_cols: bool):
        """Yield ``(dh, window_len, is_last)`` in stream order from a
        window-source factory (``factory(alloc) -> iterator of
        (buf, wlen, is_last)``), PIPELINED: the next window's file read
        and zero-padded host buffer are prepared on a background thread
        while the current window's upload and scans dispatch from THIS
        thread — the streamed analogue of the reference's load-ahead
        register loop (src/lib.rs:263-274) at window grain.

        The worker touches NO device: uploads are issued from this
        thread.  The hot tier recycles a small POOL of host buffers — each
        window's ``device_put`` is blocked one window later (a 1-deep
        upload pipeline) before its buffer returns to the pool, which also
        strictly bounds in-flight transfers.  (Both choices were made for
        an earlier, far slower host link; whether they pay over PCIe is
        an open ROADMAP item.)  ``prefetch == 0`` degrades to a serial loop (no
        thread), keeping the same pooling."""
        import queue

        use_pool = (
            self.mesh is None
            and not self._flat_mode
            and not self.batched._huge
        )
        stop = threading.Event()
        if use_pool:
            free_q = self._ensure_pool()
            # Top up buffers lost to an aborted earlier stream (items
            # dropped from the hand-off queue on early stop) — new
            # buffers re-register on first upload; correctness never
            # depends on pool population.
            target = max(self.prefetch, 1) + 2
            while free_q.qsize() < target:
                free_q.put(np.zeros((self._buf_total,), np.uint8))

            def alloc():
                t0 = time.perf_counter()
                try:
                    while True:
                        if stop.is_set():
                            raise _IngestStopped()
                        try:
                            return free_q.get(timeout=0.05)
                        except queue.Empty:
                            continue
                finally:
                    # Pool backpressure (consumer still draining) — also
                    # inside read_s, so pure file IO = read_s - buf_wait_s.
                    self._stats_add(
                        "buf_wait_s", time.perf_counter() - t0
                    )

            windows = self._timed_windows(iter(factory(alloc)))
        else:
            windows = self._timed_windows(iter(factory(None)))
        pending: List = []  # (DeviceHaystack, host_buf) awaiting recycle

        def _retire(entry):
            """A buffer is safe to mutate only once NOTHING will read it
            again: block the window's derived packed windows (cols for
            positions streams) — their materialization ends all reads of
            the source buffer.  (Blocking just the device_put is NOT
            enough on backends where it aliases the host buffer
            zero-copy, e.g. CPU.)"""
            odh, ob = entry
            jax.block_until_ready(
                odh.pw if odh.pw is not None else odh.require_cols()
            )
            free_q.put(ob)

        def make_dh(buf):
            """Main-thread device_put + one-window-delayed pool recycle.
            ``upload_s`` counts the device_put issue and the previous
            window's retirement wait ONLY (prep_s is accrued separately
            inside _prep — the stats keys stay disjoint)."""
            if not use_pool:
                return self._prep(buf, need_cols)
            t0 = time.perf_counter()
            dev = jnp.asarray(buf)
            self._stats_add("upload_s", time.perf_counter() - t0)
            dh = self._prep(dev, need_cols)
            pending.append((dh, buf))
            if len(pending) > 1:
                t0 = time.perf_counter()
                _retire(pending.pop(0))
                self._stats_add("upload_s", time.perf_counter() - t0)
            return dh

        try:
            if self.prefetch == 0:
                for buf, wlen, is_last in windows:
                    yield make_dh(buf), wlen, is_last
                return
            q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
            sentinel = object()
            failure: List[BaseException] = []

            def worker():
                try:
                    for item in windows:  # (buf, wlen, is_last) — host only
                        if stop.is_set():
                            return
                        while not stop.is_set():
                            try:
                                q.put(item, timeout=0.05)
                                break
                            except queue.Full:
                                continue
                except _IngestStopped:
                    return
                except BaseException as e:  # surfaced on the consumer side
                    failure.append(e)
                finally:
                    while not stop.is_set():
                        try:
                            q.put(sentinel, timeout=0.05)
                            break
                        except queue.Full:
                            continue

            t = threading.Thread(
                target=worker, name="sliceslice-ingest", daemon=True
            )
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is sentinel:
                        if failure:
                            raise failure[0]
                        return
                    buf, wlen, is_last = item
                    yield make_dh(buf), wlen, is_last
            finally:
                # Early stop (or consumer error): unblock + retire worker,
                # returning any pooled buffers still in the hand-off queue.
                stop.set()
                while True:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                    if use_pool and isinstance(item, tuple):
                        free_q.put(item[0])
                t.join(timeout=5.0)
        finally:
            stop.set()
            for entry in pending:
                try:
                    _retire(entry)
                except Exception:
                    free_q.put(entry[1])
            pending.clear()

    def _ensure_pool(self):
        """Lazy pool of recycled window host buffers (uploaded once by
        :meth:`warmup`); sized so the worker, the queue,
        and the consumer's 1-deep upload pipeline never starve."""
        if self._pool_q is None:
            import queue

            q: "queue.Queue" = queue.Queue()
            for _ in range(max(self.prefetch, 1) + 2):
                q.put(np.zeros((self._buf_total,), np.uint8))
            self._pool_q = q
        return self._pool_q

    def _group_ends(self, grp, wlen: int, is_last: bool) -> np.ndarray:
        """Window-local valid-position bounds for one width group: count
        positions only in [0, window) — the overlap peek belongs to the
        next window — except in the final window, where the stream's true
        end applies."""
        grp.sync_host()  # a device-side reorder may not be materialized
        lens = grp.lengths
        end_local = wlen - lens + 1 if is_last else np.minimum(
            self.window, wlen - lens + 1
        )
        return grp.pad_ends(np.maximum(end_local, 0))

    def _window_ends_dev(self, wlen: int, is_last: bool):
        """Per-group device ends for one window: the hoisted constants for
        full non-final windows (the common case — zero uploads), a fresh
        host->device conversion only for the stream's final window and the
        rare short-read non-final one."""
        if not is_last and wlen >= self._wcap:
            return self._ends_full_dev
        return tuple(
            jnp.asarray(self._group_ends(grp, wlen, is_last))
            for grp in self.batched.groups
        )

    def _find_step_fn(self, dh):
        """ONE jit program per window for the tiled single-chip find
        stream: every group's scan kernel + the input-order scatter + the
        lexicographic (window, local) device fold — the streaming analogue
        of the batched ``_sweep_fn`` (models/batched.py): one dispatch
        per window."""
        key = ("find", dh.s, dh.g, dh.kh, dh.length)
        fn = self._step_cache.get(key)
        if fn is not None:
            return fn
        bs = self.batched
        n = len(bs)
        s = dh.s
        sizes = tuple(g.n for g in bs.groups)

        @jax.jit
        def step(pw, order, tables, w_idx, best_w, best_l):
            parts = [
                scan_kernel.batched_find_cols(None, v, m, e, s=s, pw=pw)
                for v, m, e in tables
            ]
            merged = jnp.concatenate(
                [p[:sz] for p, sz in zip(parts, sizes)]
            )
            local = (
                jnp.full((n,), SENTINEL, jnp.int32).at[order].set(merged)
            )
            cand_w = jnp.where(
                local < SENTINEL, w_idx, jnp.int32(SENTINEL)
            )
            better = jnp.logical_or(
                cand_w < best_w,
                jnp.logical_and(cand_w == best_w, local < best_l),
            )
            return (
                jnp.where(better, cand_w, best_w),
                jnp.where(better, local, best_l),
            )

        self._step_cache[key] = step
        return step

    def _count_step_fn(self, dh):
        """Fused per-window count step: group count kernels + scatter + the
        two-limb uint32 fold, one dispatch per window."""
        key = ("count", dh.s, dh.g, dh.kh, dh.length)
        fn = self._step_cache.get(key)
        if fn is not None:
            return fn
        bs = self.batched
        n = len(bs)
        s = dh.s
        sizes = tuple(g.n for g in bs.groups)

        @jax.jit
        def step(pw, order, tables, hi, lo):
            parts = [
                scan_kernel.batched_count_cols(None, v, m, e, s=s, pw=pw)
                for v, m, e in tables
            ]
            merged = jnp.concatenate(
                [p[:sz] for p, sz in zip(parts, sizes)]
            )
            local = jnp.zeros((n,), jnp.int32).at[order].set(merged)
            c = local.astype(jnp.uint32)
            lo2 = lo + c
            carry = (lo2 < c).astype(jnp.uint32)
            return hi + carry, lo2

        self._step_cache[key] = step
        return step

    def _group_tables(self, ends):
        return tuple(
            (g.values_dev, g.masks_dev, e)
            for g, e in zip(self.batched.groups, ends)
        )

    def _huge_prefix_counts(self, dh):
        """Per-window prefix-candidate counts for ALL huge needles: one
        batched scan, one small readback (int32[H]) — the per-window tier
        decisions for every needle at the cost one needle used to pay."""
        grp = self._huge_prefix_grp
        out = scan_kernel.batched_count_cols(
            None, grp.values_dev, grp.masks_dev, self._huge_pref_ends,
            s=dh.s, pw=dh.windows(),
        )
        return np.asarray(out)[: grp.n]

    def _fold_huge_find(
        self, best, dh, wlen: int, base: int, is_last: bool
    ) -> None:
        bs = self.batched
        pending = [(i, hs) for i, hs in bs._huge if best[i] < 0]
        if not pending:
            return
        batched = dh.tiled and self.mesh is None
        cnts = self._huge_prefix_counts(dh) if batched else None
        for i, hs in pending:
            if cnts is not None:
                nc = int(cnts[self._huge_slot[i]])
                if nc == 0:
                    continue  # prefix absent -> needle absent in window
                p = hs.find_with_candidates(dh, nc)
            else:
                p = hs.find(dh)
            if p is not None and p < self._end_h(hs.size, wlen, is_last):
                best[i] = base + p

    def _count(self, windows: Iterator[bytes]) -> np.ndarray:
        bs = self.batched
        n = len(bs)
        totals = np.zeros((n,), dtype=np.int64)
        # Device two-limb accumulator: window counts fold ON DEVICE and the
        # stream reads back once at the end — zero mid-stream device->host
        # traffic (see _count_fold64), constant device memory.  Host-side
        # parts (the sharded int64 guard path) fold on host as before.
        hi = lo = None
        pending: List = []
        since = 0
        self._reset_stats("count")
        for dh, wlen, is_last in self._ingest(windows, need_cols=False):
            tw0 = time.perf_counter()
            hcnts = (
                self._huge_prefix_counts(dh)
                if bs._huge and dh.tiled and self.mesh is None else None
            )
            for i, hs in bs._huge:
                if hcnts is not None:
                    nc = int(hcnts[self._huge_slot[i]])
                    if nc == 0:
                        continue
                    pos = hs.positions_with_candidates(dh, nc)
                else:
                    pos = hs.positions(dh)
                end_h = self._end_h(hs.size, wlen, is_last)
                totals[i] += int((pos < end_h).sum())
            if bs.groups:
                if self.mesh is None and dh.tiled:
                    # Hot path: one fused dispatch per window (count
                    # kernels + scatter + two-limb device fold).
                    t0 = time.perf_counter()
                    if hi is None:
                        hi = jnp.zeros((n,), jnp.uint32)
                        lo = jnp.zeros((n,), jnp.uint32)
                    ends = self._window_ends_dev(wlen, is_last)
                    hi, lo = self._count_step_fn(dh)(
                        dh.windows(), bs._order_dev,
                        self._group_tables(ends), hi, lo,
                    )
                    self._stats_add(
                        "dispatch_s", time.perf_counter() - t0
                    )
                else:
                    # Converted at the check_every cadence (_fold_counts),
                    # not per window.
                    pending.append(self._count_window(dh, wlen, is_last))
            since += 1
            self.stats["windows"] = self.stats.get("windows", 0) + 1
            self.stats["bytes"] += wlen
            if since >= self.check_every:
                since = 0
                self._fold_counts(totals, pending)
                if lo is not None:
                    # Drain the device queue (a wait, NOT a readback): an
                    # unsynced stream would pile up in-flight window
                    # buffers without bound.
                    t0 = time.perf_counter()
                    jax.block_until_ready(lo)
                    self._stats_add("drain_s", time.perf_counter() - t0)
            self.stats["window_ms"].append(
                1e3 * (time.perf_counter() - tw0)
            )
        self._fold_counts(totals, pending)
        if hi is not None:
            totals += (np.asarray(hi).astype(np.int64) << 32) + np.asarray(
                lo
            ).astype(np.int64)
        return totals

    def _count_window(self, dh, wlen: int, is_last: bool):
        """Mesh and flat-window count (the tiled single-chip path rides
        the fused ``_count_step_fn`` instead)."""
        bs = self.batched
        parts = []
        blobs = []
        for grp in bs.groups:
            end_local = self._group_ends(grp, wlen, is_last)
            if self.mesh is not None:
                from ..parallel.shard_scan import sharded_count_cols

                local = sharded_count_cols(
                    dh, grp.values_dev, grp.masks_dev,
                    end_local, self.mesh,
                )
            else:
                # Flat tiny windows: host counts stay host-side (no
                # pointless device round trip before the host fold).
                local = np.asarray(
                    [
                        _host_count_limited(dh.host_bytes, nd, int(e))
                        for nd, e in zip(
                            [bs.needles[i] for i in grp.indices],
                            end_local,
                        )
                    ],
                    np.int64,
                )
            parts.append(local)
            blobs.append(grp.indices.tobytes())
        return self._merge_parts(parts, blobs, absent=0)

    def _merge_parts(self, parts, blobs, absent: int):
        """Scatter per-group window results to input order.  Device parts
        fuse into one int32 device scatter; host int64 parts (the sharded
        >2 GiB-padding guard path — unreachable with default windows but
        exact if hit) scatter on host, preserving int64."""
        bs = self.batched
        n = len(bs)
        if parts and isinstance(parts[0], np.ndarray):
            out = np.full((n,), absent, np.int64)
            for grp, p in zip(bs.groups, parts):
                out[grp.indices] = p[: grp.n]
            return out
        from ..models.batched import _scatter_groups

        return _scatter_groups(n, tuple(blobs), parts)

    def _scan(
        self, windows: Iterator[bytes], early_stop: bool, base0: int = 0
    ) -> np.ndarray:
        bs = self.batched
        n = len(bs)
        # int64 host accumulator: windows arrive in stream order, so a slot
        # is finalized by the FIRST window whose local scan reports a match.
        # Device results stay window-local int32 and fold every check_every
        # windows (and at the end) — no per-window sync, bounded buffers.
        best = np.full((n,), -1, dtype=np.int64)
        # Device lexicographic-(window, local) accumulator: window results
        # fold ON DEVICE and the stream reads back once at the end (plus a
        # small cadence snapshot only when early_stop needs one) — see
        # _first_fold.  Host-side parts (the sharded int64 guard path) keep
        # the host fold.
        best_w = best_l = None
        pending: List[Tuple[int, jax.Array]] = []
        base = int(base0)
        w_idx = 0
        since_check = 0
        self._reset_stats("find")
        # windows_only inside _prep: the scan consumes packed windows only,
        # so each window pins ~4 bytes/byte on device instead of ~5.
        for dh, wlen, is_last in self._ingest(windows, need_cols=False):
            tw0 = time.perf_counter()
            self._fold_huge_find(best, dh, wlen, base, is_last)
            if bs.groups:
                if self.mesh is None and dh.tiled:
                    # Hot path: ONE fused dispatch per window (kernels +
                    # scatter + device fold), hoisted full-window ends.
                    t0 = time.perf_counter()
                    if best_w is None:
                        best_w = jnp.full((n,), SENTINEL, jnp.int32)
                        best_l = jnp.full((n,), SENTINEL, jnp.int32)
                    ends = self._window_ends_dev(wlen, is_last)
                    best_w, best_l = self._find_step_fn(dh)(
                        dh.windows(), bs._order_dev,
                        self._group_tables(ends), jnp.int32(w_idx),
                        best_w, best_l,
                    )
                    self._stats_add(
                        "dispatch_s", time.perf_counter() - t0
                    )
                else:
                    # Mesh streams (replicated multi-process arrays) keep
                    # the host fold at the check_every cadence; flat tiny
                    # windows fold on device (_first_fold) — neither path
                    # syncs per window.
                    merged = self._window_find_slow(dh, wlen, is_last)
                    if isinstance(merged, np.ndarray) or (
                        self.mesh is not None
                    ):
                        pending.append((base, merged))
                    else:
                        if best_w is None:
                            best_w = jnp.full((n,), SENTINEL, jnp.int32)
                            best_l = jnp.full((n,), SENTINEL, jnp.int32)
                        best_w, best_l = _first_fold(
                            best_w, best_l, jnp.int32(w_idx), merged
                        )
            base += self.window
            w_idx += 1
            since_check += 1
            self.stats["windows"] = w_idx
            self.stats["bytes"] += wlen
            if since_check >= self.check_every:
                since_check = 0
                self._fold(best, pending)
                if best_w is not None:
                    # Drain the device queue (a wait, NOT a readback) —
                    # bounds in-flight window buffers; see _count's note.
                    t0 = time.perf_counter()
                    jax.block_until_ready(best_w)
                    self._stats_add("drain_s", time.perf_counter() - t0)
                if early_stop and self._all_found(best, best_w):
                    self.stats["window_ms"].append(
                        1e3 * (time.perf_counter() - tw0)
                    )
                    break
            self.stats["window_ms"].append(
                1e3 * (time.perf_counter() - tw0)
            )
        self._fold(best, pending)
        t0 = time.perf_counter()
        self._combine_device_first(best, best_w, best_l, base0)
        self._stats_add("drain_s", time.perf_counter() - t0)
        return best

    def _window_find_slow(self, dh, wlen: int, is_last: bool):
        """Per-group find for the mesh and flat-window paths (host fold)."""
        bs = self.batched
        parts = []
        blobs = []
        for grp in bs.groups:
            end_local = self._group_ends(grp, wlen, is_last)
            if self.mesh is not None:
                from ..parallel.shard_scan import sharded_find_cols

                local = sharded_find_cols(
                    dh, grp.values_dev, grp.masks_dev,
                    end_local, self.mesh,
                )
            else:
                from ..ops import xla_backend

                local = xla_backend.find_batched_flat(
                    dh.flat, grp.values_dev, grp.masks_dev,
                    jnp.asarray(end_local.astype(np.int32)),
                )
            parts.append(local)
            blobs.append(grp.indices.tobytes())
        return self._merge_parts(parts, blobs, absent=-1)

    def _all_found(self, best: np.ndarray, best_w) -> bool:
        """Early-stop check.  Reads the device accumulator — a small
        per-cadence readback, the cost of early_stop=True."""
        if best_w is None:
            return bool((best >= 0).all())
        found_dev = np.asarray(best_w) < SENTINEL
        ok = np.where(
            self._kernel_slot, (best >= 0) | found_dev, best >= 0
        )
        return bool(ok.all())

    def _combine_device_first(
        self, best: np.ndarray, best_w, best_l, base0: int
    ) -> None:
        """One final readback of the device (window, local) pairs -> int64
        global offsets for kernel-group slots still unset."""
        if best_w is None:
            return
        bw = np.asarray(best_w).astype(np.int64)
        bl = np.asarray(best_l).astype(np.int64)
        upd = (bw < SENTINEL) & self._kernel_slot & (best < 0)
        best[upd] = base0 + bw[upd] * self.window + bl[upd]

    def _positions(self, windows: Iterator[bytes], base0: int = 0) -> list:
        """Per-window bitmap scan + host decode (readback-bound, like the
        single-corpus positions_all) — window-local clipped ends give the
        exactly-once rule, the int64 window base the unbounded offsets."""
        bs = self.batched
        n = len(bs)
        out: List[List[np.ndarray]] = [[] for _ in range(n)]
        base = int(base0)
        batch = 16  # bitmap memory bound: window/8 bytes per needle
        self._reset_stats("positions")
        for dh, wlen, is_last in self._ingest(windows, need_cols=True):
            tw0 = time.perf_counter()
            self.stats["windows"] += 1
            self.stats["bytes"] += wlen
            hcnts = (
                self._huge_prefix_counts(dh)
                if bs._huge and dh.tiled and self.mesh is None else None
            )
            for i, hs in bs._huge:
                if hcnts is not None:
                    nc = int(hcnts[self._huge_slot[i]])
                    if nc == 0:
                        continue
                    pos = hs.positions_with_candidates(dh, nc)
                else:
                    pos = hs.positions(dh)
                end_h = self._end_h(hs.size, wlen, is_last)
                pos = pos[pos < end_h]
                if pos.size:
                    out[i].append(pos + base)
            for grp in bs.groups:
                ends = self._group_ends(grp, wlen, is_last)[: grp.n]
                if not dh.tiled:
                    for j, gi in enumerate(grp.indices):
                        pos = _host_positions_limited(
                            dh.host_bytes, bs.needles[gi], int(ends[j])
                        )
                        if pos.size:
                            out[gi].append(pos + base)
                    continue
                for i0 in range(0, grp.n, batch):
                    res = self._positions_batch(
                        dh,
                        grp.values_host[i0 : i0 + batch],
                        grp.masks_host[i0 : i0 + batch],
                        ends[i0 : i0 + batch],
                    )
                    for j, pos in enumerate(res):
                        if pos.size:
                            out[grp.indices[i0 + j]].append(pos + base)
            base += self.window
            self.stats["window_ms"].append(
                1e3 * (time.perf_counter() - tw0)
            )
        return [
            np.concatenate(p) if p else np.empty((0,), np.int64)
            for p in out
        ]

    #: per-window sparse-positions budget: needles with at most this many
    #: matches in a window read back ``cap`` words instead of the
    #: window/8-byte bitmap (the dominant readback of a positions stream).
    sparse_cap = SPARSE_POSITIONS_CAP

    def _positions_batch(self, dh, vals, msks, ends) -> list:
        from ..ops import xla_backend

        if self.mesh is not None:
            from ..parallel.shard_scan import sharded_positions

            return sharded_positions(
                dh, vals, msks, ends, self.mesh,
                sparse_cap=self.sparse_cap,
            )
        return xla_backend.two_tier_positions(
            dh.require_cols(), vals, msks, ends, dh.s, self.sparse_cap
        )

    def _fold_counts(self, totals: np.ndarray, pending: List) -> None:
        for arr in pending:
            totals += np.asarray(arr).astype(np.int64)
        pending.clear()

    def _fold(self, best: np.ndarray, pending: List[Tuple[int, object]]) -> None:
        """Fold window-local device results into the int64 host accumulator
        (in stream order, first window with a match wins).  Device parts
        are int32 with SENTINEL = absent; host int64 parts (the sharded
        padding-overflow guard path) use -1 = absent.  Only kernel-group
        slots fold — huge-needle slots are zero-init scatter filler here
        and are written by :meth:`_fold_huge_find` instead."""
        for wbase, arr in pending:
            local = np.asarray(arr)
            if local.dtype == np.int64:
                upd = (best < 0) & (local >= 0) & self._kernel_slot
            else:
                upd = (best < 0) & (local < SENTINEL) & self._kernel_slot
            best[upd] = local[upd].astype(np.int64) + wbase
        pending.clear()
