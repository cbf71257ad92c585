"""Batched multi-needle searcher — the flagship workload shape.

The reference searches one needle at a time and amortizes preprocessing
across haystacks; on the device the economic unit is the *batch*: N needles
scanned over a device-resident haystack in kernel sweeps, so each window
tile is loaded once per needle-block instead of once per needle.

Needles are grouped by probe-table width T = ceil(k/4) at construction time
(the batched generalization of the reference's per-length dispatch family,
src/x86.rs:397-526): each group runs a straight-line kernel with exactly its
probe count — no wasted probe slots, no in-kernel branching.  Group results
are re-scattered to input order on device and fetched with a single
device-to-host read.

The reference's first-match early exit (src/lib.rs:242-244) lives INSIDE the
kernel here: each program walks its segments until every needle of its
block has a published match (ops/scan_kernel.py), so a settled block stops
issuing loads or compares entirely.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..needle import MAX_NEEDLE_LEN, as_bytes, build_probe_table, num_probes
from ..ops import scan_kernel, xla_backend
from ..ops.layout import DeviceHaystack, preprocess
from ..ops.scan_math import SENTINEL
from ..searcher import HaystackLike, _hay_bytes

#: Probe widths up to this get a group (and a compiled kernel) of their
#: own: no wasted probe slots.  Wider tables are bucketed so long-needle
#: lists compile a bounded number of kernel widths.
EXACT_T_MAX = 8
WIDE_T_BUCKETS = (16, 32, 64, 128, 256, 512)


def _t_bucket(t: int) -> int:
    if t <= EXACT_T_MAX:
        return max(t, 1)
    for b in WIDE_T_BUCKETS:
        if t <= b:
            return b
    raise ValueError(f"needle needs {t} probes > max bucket {WIDE_T_BUCKETS[-1]}")


class _Group:
    """Needles sharing one probe-table width: device-resident tables,
    pre-padded to the kernel's block plan so the per-sweep hot path issues
    zero table-shaping dispatches."""

    def __init__(
        self,
        indices: np.ndarray,
        needles: List[bytes],
        t: int,
    ):
        self.indices = indices
        self.t = t
        self.n = len(needles)
        vals, msks, lens = build_probe_table(needles, t_max=t)
        self.lengths = lens
        # Host copies stay alongside the device tables: the positions paths
        # slice rows on host, and reading them back per call would be an
        # avoidable device->host transfer.
        self.values_host = vals
        self.masks_host = msks
        self.n_pad = scan_kernel.plan_block(self.n)
        rowpad = ((0, self.n_pad - self.n), (0, 0))
        self.values_dev = jnp.asarray(np.pad(vals, rowpad), jnp.uint32)
        self.masks_dev = jnp.asarray(np.pad(msks, rowpad), jnp.uint32)
        self._ends_cache: dict[int, jnp.ndarray] = {}
        #: device row permutation not yet applied to the HOST copies — set
        #: by the device-side optimizer (zero-readback reschedule); host
        #: readers call :meth:`sync_host` first (one tiny readback, lazy).
        self._host_perm_pending = None

    def sync_host(self) -> None:
        """Materialize a pending device-side row permutation into the host
        copies (indices/lengths/values/masks).  The readback is a single
        int32[n] vector — deferred until a host consumer (positions paths,
        a host reorder, a new ends length) actually needs row order."""
        if self._host_perm_pending is None:
            return
        perm = np.asarray(self._host_perm_pending)[: self.n]
        self._host_perm_pending = None
        self.indices = self.indices[perm]
        self.lengths = self.lengths[perm]
        self.values_host = self.values_host[perm]
        self.masks_host = self.masks_host[perm]

    #: retained per-haystack-length device ends (FIFO-evicted; a serving
    #: loop over many distinct corpus lengths must not grow unboundedly).
    _ENDS_CACHE_CAP = 16

    def pad_ends(self, ends: np.ndarray) -> np.ndarray:
        """Zero-pad per-needle ends to the padded row count (end 0 = padded
        slot can never report a match)."""
        return np.pad(
            np.asarray(ends, np.int32), ((0, self.n_pad - self.n),)
        )

    def reorder(self, key: np.ndarray) -> None:
        """Permute this group's rows ascending by ``key`` (adaptive block
        scheduling, see BatchedSearcher.optimize_for).  The scatter maps
        results back through ``indices``, so row order is free to change;
        padded table rows stay at the end untouched."""
        self.sync_host()
        perm = np.argsort(key, kind="stable")
        self.indices = self.indices[perm]
        self.lengths = self.lengths[perm]
        self.values_host = self.values_host[perm]
        self.masks_host = self.masks_host[perm]
        # Rebuild the device tables from the permuted HOST copies — reading
        # the device tables back first would cost a device->host round trip
        # per table for bytes we already hold.
        rowpad = ((0, self.n_pad - self.n), (0, 0))
        self.values_dev = jnp.asarray(
            np.pad(self.values_host, rowpad), jnp.uint32
        )
        self.masks_dev = jnp.asarray(
            np.pad(self.masks_host, rowpad), jnp.uint32
        )
        self._ends_cache.clear()

    def ends_dev(self, hay_len: int) -> jnp.ndarray:
        e = self._ends_cache.get(hay_len)
        if e is None:
            # Cache miss builds from host lengths — materialize any
            # pending device permutation first so row order matches the
            # (device-permuted) tables.  Cached entries are permuted
            # device-side by the optimizer and never hit this.
            self.sync_host()
            e = jnp.asarray(
                self.pad_ends(np.maximum(hay_len - self.lengths + 1, 0)),
                jnp.int32,
            )
            self._ends_cache[hay_len] = e
            while len(self._ends_cache) > self._ENDS_CACHE_CAP:
                self._ends_cache.pop(next(iter(self._ends_cache)))
        return e


class BatchedSearcher:
    def __init__(self, needles: Sequence, position: Optional[int] = None):
        self.needles = [as_bytes(n) for n in needles]
        if position is not None:
            # Same contract every single-needle searcher enforces
            # (reference: position < needle.size(), src/x86.rs:300); the
            # dense kernels don't use position, but accepting an invalid
            # one here while DynamicSearcher raises would be a trap.
            for nd in self.needles:
                if not (0 <= position < len(nd)):
                    raise ValueError(
                        f"invalid position {position} for needle of "
                        f"length {len(nd)}"
                    )
        # Needles beyond the kernels' probe-table budget take the
        # filter+verify fallback (models/huge.py) — arbitrary-length parity
        # with the reference (src/lib.rs:52-59).  They are excluded from the
        # kernel groups (and from max_len, which sizes layout halos).
        self._huge: List[tuple[int, object]] = []
        kernel_idx = []
        for i, nd in enumerate(self.needles):
            if len(nd) > MAX_NEEDLE_LEN:
                from .huge import HugeNeedleSearcher

                self._huge.append((i, HugeNeedleSearcher(nd, position)))
            else:
                kernel_idx.append(i)
        self.max_len = max(
            (len(self.needles[i]) for i in kernel_idx), default=0
        )
        buckets: dict[int, list[int]] = {}
        for i in kernel_idx:
            t = _t_bucket(max(1, num_probes(len(self.needles[i]))))
            buckets.setdefault(t, []).append(i)
        self.groups = [
            _Group(
                np.asarray(idx, np.int64), [self.needles[i] for i in idx], t
            )
            for t, idx in sorted(buckets.items())
        ]
        self.max_t = max((g.t for g in self.groups), default=1)
        #: true (unpadded) row count per group — static across reorders.
        self._order_sizes = tuple(g.n for g in self.groups)
        self._rebuild_order()

        #: fused-sweep jit closures keyed by layout shape (FIFO-evicted —
        #: each entry pins a compiled executable).
        self._sweep_cache: dict = {}
        #: bumped by optimize_for (group rows permuted) so downstream
        #: caches of placed tables (ShardedBatchedSearcher) invalidate.
        self._epoch = 0

    def _rebuild_order(self) -> None:
        """Device copy of the concatenated group->input scatter order.  Kept
        as a kernel OPERAND (not a baked constant) so optimize_for's row
        permutation is a device_put, not a recompile of every sweep
        program."""
        for g in self.groups:
            g.sync_host()
        idx = [g.indices for g in self.groups]
        self._order_dev = jnp.asarray(
            np.concatenate(idx).astype(np.int32)
            if idx else np.zeros((0,), np.int32)
        )

    _SWEEP_CACHE_CAP = 16

    def _sweep_cache_put(self, key, fn):
        self._sweep_cache[key] = fn
        while len(self._sweep_cache) > self._SWEEP_CACHE_CAP:
            self._sweep_cache.pop(next(iter(self._sweep_cache)))
        return fn

    def __len__(self) -> int:
        return len(self.needles)

    def _sweep_fn(self, dh: DeviceHaystack):
        """One fused jit per layout shape: every group's scan kernel plus the
        re-scatter in a single device program — a single dispatch per sweep."""
        key = (dh.s, dh.g, dh.kh, dh.length)
        fn = self._sweep_cache.get(key)
        if fn is not None:
            return fn
        n = len(self.needles)
        sizes = self._order_sizes
        s = dh.s

        @jax.jit
        def sweep(pw, order, tables):
            parts = [
                scan_kernel.batched_find_cols(None, v, m, e, s=s, pw=pw)
                for v, m, e in tables
            ]
            return _scatter_jit(n, sizes)(order, *parts)

        return self._sweep_cache_put(key, sweep)

    def _count_sweep_fn(self, dh: DeviceHaystack):
        """Fused occurrence-count sweep (capability extension): every
        group's count kernel + re-scatter, one device program."""
        key = ("count", dh.s, dh.g, dh.kh, dh.length)
        fn = self._sweep_cache.get(key)
        if fn is not None:
            return fn
        n = len(self.needles)
        sizes = self._order_sizes
        s = dh.s

        @jax.jit
        def sweep(pw, order, tables):
            parts = [
                scan_kernel.batched_count_cols(None, v, m, e, s=s, pw=pw)
                for v, m, e in tables
            ]
            return _scatter_jit(n, sizes)(order, *parts)

        return self._sweep_cache_put(key, sweep)

    def count_all_device(self, hay: HaystackLike, _allow_huge: bool = False):
        """Device-resident int32[N] overlapping-occurrence counts (excludes
        huge needles — their verify step is host-side; use ``count_all``)."""
        if self._huge and not _allow_huge:
            raise ValueError(
                "count_all_device cannot evaluate needles longer than "
                f"MAX_NEEDLE_LEN={MAX_NEEDLE_LEN} (host verify step); "
                "use count_all"
            )
        dh = self._layout(hay)
        if not dh.tiled:
            raise ValueError(
                "count_all requires a tiled layout "
                "(preprocess with force_cols=True for short haystacks)"
            )
        tables = tuple(
            (g.values_dev, g.masks_dev, g.ends_dev(dh.length))
            for g in self.groups
        )
        return self._count_sweep_fn(dh)(dh.windows(), self._order_dev, tables)

    def count_all(self, hay: HaystackLike) -> np.ndarray:
        """Overlapping occurrence count per needle (int64[N]) — extension
        over the reference's bool sweep; no early exit exists to recover
        (absence proofs and counts both need the full scan)."""
        dh = self._layout(hay)
        if not dh.tiled:
            from ..searcher import overlapping_count

            data = dh.host_bytes
            if data is None:
                raise ValueError(
                    "counting on a flat DeviceHaystack requires host bytes"
                )
            return np.array(
                [overlapping_count(data, nd) for nd in self.needles],
                dtype=np.int64,
            )
        if self.groups:
            out = np.asarray(
                self.count_all_device(dh, _allow_huge=True)
            ).astype(np.int64)
        else:
            out = np.zeros((len(self.needles),), np.int64)
        for i, hs in self._huge:
            out[i] = hs.count_in(dh)
        return out

    def _layout(self, hay: HaystackLike) -> DeviceHaystack:
        # Halo must cover the widest group's probe table — and the huge
        # needles' 64-byte prefix filter, so their positions scan reuses
        # this layout instead of relayouting per needle.
        from ..needle import needed_halo_for_t

        need = needed_halo_for_t(self.max_t)
        if self._huge:
            from .huge import PREFIX_LEN

            need = max(need, PREFIX_LEN - 1)
        if isinstance(hay, DeviceHaystack):
            return hay.ensure_halo(need)
        return preprocess(_hay_bytes(hay), kh=need)

    def find_all(self, hay: HaystackLike) -> np.ndarray:
        """First-match offset per needle; -1 where absent.  Early-exit
        economics are in-kernel (per-block segment-walk exit,
        ops/scan_kernel.py) — no scheduling knobs needed."""
        n = len(self.needles)
        if n == 0:
            return np.zeros((0,), np.int64)
        # One layout for the kernel sweep AND the huge-needle fills (the
        # halo covers both; re-preprocessing per huge needle measured as
        # O(huge) redundant corpus uploads).
        dh = self._layout(hay)
        if self.groups:
            firsts = self.find_all_device(dh, _allow_huge=True)
            out = np.asarray(firsts).astype(np.int64)  # one device->host read
            out[out >= SENTINEL] = -1
        else:
            out = np.full((n,), -1, np.int64)
        return self._fill_huge(out, dh)

    def _fill_huge(self, out: np.ndarray, hay: HaystackLike) -> np.ndarray:
        """Overwrite huge-needle slots (filter+verify path, models/huge.py);
        kernel sweeps leave them unspecified."""
        for i, hs in self._huge:
            f = hs.find(hay)
            out[i] = -1 if f is None else f
        return out

    def find_all_device(self, hay: HaystackLike, _allow_huge: bool = False):
        """Device-resident variant: int32[N] first offsets (SENTINEL where
        absent), no host transfer.  The building block for pipelined
        throughput (keep results on device, sync once per batch of queries).
        Excludes huge needles (their verify step is host-side — use
        ``find_all``)."""
        if self._huge and not _allow_huge:
            raise ValueError(
                "find_all_device cannot evaluate needles longer than "
                f"MAX_NEEDLE_LEN={MAX_NEEDLE_LEN} (host verify step); "
                "use find_all"
            )
        n = len(self.needles)
        dh = self._layout(hay)
        if not dh.tiled:
            parts = [
                xla_backend.find_batched_flat(
                    dh.flat,
                    g.values_dev,
                    g.masks_dev,
                    g.ends_dev(dh.length),
                )
                for g in self.groups
            ]
        else:
            tables = tuple(
                (g.values_dev, g.masks_dev, g.ends_dev(dh.length))
                for g in self.groups
            )
            return self._sweep_fn(dh)(dh.windows(), self._order_dev, tables)
        return _scatter_jit(n, self._order_sizes)(self._order_dev, *parts)

    def search_all(self, hay: HaystackLike) -> np.ndarray:
        return self.find_all(hay) >= 0

    def optimize_for(
        self, hay: HaystackLike, firsts: Optional[np.ndarray] = None
    ) -> "BatchedSearcher":
        """Adaptive block scheduling: reorder each width group's rows
        ascending by measured first-match offsets, so needles that finish
        together share kernel blocks and blocks retire as early as possible
        (a block walks segments until its SLOWEST needle is found).
        Results are exact regardless of row order — only scheduling
        changes.

        ``firsts``: offsets from a prior :meth:`find_all` over a similar
        corpus (-1 absent).  A serving loop is already producing these, so
        passing them makes the reschedule a pure host-permute + device
        upload — no measuring sweep.  Omitted, the COLD path runs one
        measuring sweep and stays on device end to end: sweep output ->
        device argsort -> device permute of tables/ends/scatter-order —
        zero readbacks, zero uploads (host table copies sync lazily on
        demand).
        Returns self."""
        if firsts is None:
            dh = self._layout(hay)
            if dh.tiled and not self._huge and self.groups:
                self._apply_schedule_device(self.find_all_device(dh))
                return self
            firsts = self.find_all(hay)
        self._apply_schedule(np.asarray(firsts))
        return self

    def _apply_schedule_device(self, firsts) -> None:
        """Device-side reschedule from a device-resident measuring sweep
        (int32[N] firsts, SENTINEL absent — absent rows sort last, same
        order as the host path's int64-max mapping)."""
        sizes = self._order_sizes
        n_pads = tuple(g.n_pad for g in self.groups)
        ends_keys = tuple(tuple(g._ends_cache.keys()) for g in self.groups)
        flat = []
        for g in self.groups:
            flat.append(g.values_dev)
            flat.append(g.masks_dev)
            flat.extend(g._ends_cache.values())
        new_order, outs = _device_schedule_jit(
            sizes, n_pads, tuple(len(k) for k in ends_keys)
        )(firsts, self._order_dev, *flat)
        for g, keys, (v2, m2, e2, p) in zip(self.groups, ends_keys, outs):
            g.values_dev = v2
            g.masks_dev = m2
            g._ends_cache = dict(zip(keys, e2))
            # Compose with any earlier un-synced device permutation:
            # host rows A, device rows A[p1][p2] = A[p1[p2]].
            g._host_perm_pending = (
                p if g._host_perm_pending is None
                else g._host_perm_pending[p]
            )
        self._order_dev = new_order
        self._epoch += 1

    def _apply_schedule(self, firsts: np.ndarray) -> None:
        """Apply a measured first-offset schedule: reorder group rows and
        bump the epoch so downstream placed-table caches invalidate.  The
        sweep closures survive unchanged — tables AND the scatter order are
        kernel operands, so a reorder is a handful of device_puts with ZERO
        recompiles.  Shared by the single-device and sharded
        optimizers (each supplies its own measuring sweep)."""
        key = np.where(firsts < 0, np.iinfo(np.int64).max, firsts)
        for g in self.groups:
            g.sync_host()  # indices must be current before keying
            g.reorder(key[g.indices])
        self._rebuild_order()
        self._epoch += 1

    def positions_all(
        self,
        hay: HaystackLike,
        batch: int = 16,
        sparse_cap: int = xla_backend.SPARSE_POSITIONS_CAP,
    ) -> List[np.ndarray]:
        """ALL (overlapping) match offsets per needle, in input order —
        the batched ``find_iter`` capability.  Adaptive two-tier scan:
        the device first COMPACTS each needle's matches to its
        ``sparse_cap`` earliest offsets (readback = cap words per needle —
        ~1000x less than the bitmap for sparse needles, the common case);
        needles whose device count exceeds the cap fall back to the packed
        match bitmap (corpus/8 bytes each), read back ``batch`` needles at
        a time.  Prefer ``find_all``/``count_all`` when only first offsets
        or totals are needed."""
        from ..searcher import _host_positions

        dh = self._layout(hay)
        if not dh.tiled:
            data = dh.host_bytes
            if data is None:
                raise ValueError(
                    "positions on a flat DeviceHaystack requires host bytes"
                )
            return [_host_positions(data, nd) for nd in self.needles]
        out: List[Optional[np.ndarray]] = [None] * len(self.needles)
        cols = dh.require_cols()
        for g in self.groups:
            g.sync_host()  # materialize any pending device-side reorder
            vals = g.values_host  # host copies kept at build time — no
            msks = g.masks_host   # device->host table readback per call
            ends = np.maximum(dh.length - g.lengths + 1, 0).astype(np.int32)
            for i0 in range(0, g.n, batch):
                res = xla_backend.two_tier_positions(
                    cols,
                    vals[i0 : i0 + batch],
                    msks[i0 : i0 + batch],
                    ends[i0 : i0 + batch],
                    dh.s,
                    sparse_cap,
                )
                for j, p in enumerate(res):
                    out[g.indices[i0 + j]] = p
        for i, hs in self._huge:
            out[i] = hs.positions(dh)
        return out  # type: ignore[return-value]


@functools.lru_cache(maxsize=32)
def _device_schedule_jit(sizes: tuple, n_pads: tuple, n_ends: tuple):
    """One fused device program applying an adaptive block schedule: per
    group, gather the measuring sweep's firsts through the scatter order,
    argsort (jnp sorts are stable; SENTINEL-absent rows sort last, like
    the host path), and permute the real rows of values/masks and every
    cached ends vector; padded rows stay in place.  Returns the new
    concatenated scatter order and per-group (values, masks, ends...,
    perm).  Everything is an operand — a reschedule never recompiles the
    sweep programs (same property as the host path)."""

    @jax.jit
    def apply(firsts, order, *flat):
        i = 0
        off = 0
        new_order = []
        outs = []
        for sz, _npad, ne in zip(sizes, n_pads, n_ends):
            v, m = flat[i], flat[i + 1]
            ends = flat[i + 2 : i + 2 + ne]
            i += 2 + ne
            idx = jax.lax.slice_in_dim(order, off, off + sz)
            off += sz
            p = jnp.argsort(firsts[idx]).astype(jnp.int32)
            new_order.append(idx[p])
            outs.append((
                v.at[:sz].set(v[:sz][p]),
                m.at[:sz].set(m[:sz][p]),
                tuple(e.at[:sz].set(e[:sz][p]) for e in ends),
                p,
            ))
        return (
            jnp.concatenate(new_order) if new_order else order,
            tuple(outs),
        )

    return apply


@functools.lru_cache(maxsize=64)
def _scatter_jit(n: int, sizes: tuple):
    """Fused unpad+concat+scatter, keyed only on the STATIC shape facts
    (output length, true group sizes).  The permutation itself is an
    operand, so reordering rows (optimize_for) never recompiles this."""

    @jax.jit
    def scatter(order, *parts):
        merged = jnp.concatenate(
            [p[:sz].astype(jnp.int32) for p, sz in zip(parts, sizes)]
        )
        return jnp.zeros((n,), jnp.int32).at[order].set(merged)

    return scatter


def _scatter_groups(n: int, index_blobs: tuple, parts):
    """Scatter per-group results back to input order — one fused device
    program (unpad slices + concat + scatter).  Convenience wrapper for
    callers holding host index blobs (streaming/sharded merge paths); the
    hot batched sweeps call ``_scatter_jit`` with a device-resident order
    operand directly."""
    sizes = tuple(
        len(b) // 8 for b in index_blobs
    )  # int64 indices -> true group sizes
    order = jnp.asarray(
        np.concatenate(
            [np.frombuffer(b, dtype=np.int64) for b in index_blobs]
        ).astype(np.int32)
        if index_blobs
        else np.zeros((0,), np.int32)
    )
    return _scatter_jit(n, sizes)(order, *parts)
