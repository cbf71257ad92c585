"""Distributed corpus scanner — the new L5 layer (absent in the single-core
reference; specified by BASELINE.json: corpus sharded data-parallel, needle
tables replicated, match flags/offsets reduced via collectives).

Because layout segments are self-contained (each carries its own halo bytes,
ops/layout.py), sharding the segment axis requires NO neighbor communication:
each device scans its shard with the same Pallas kernel the single-device
path uses, computing *shard-local* int32 offsets, and the global first
match is a lexicographic minimum over (shard index, local offset) — two
tiny int32 ``pmin``s per query batch.  Device math never leaves int32, so
global corpora beyond the 2 GiB int32 range are exact (the reference is
offset-size agnostic via usize, src/lib.rs:253-287): when the combined
offset ``shard * shard_bytes + local`` fits int32 it is produced on device
(API identical to round 1); past 2 GiB the int64 combine happens on host.
Cross-shard-boundary matches are counted exactly once: a match belongs to
the shard where its first byte lives (halo bytes are read-only context),
the reference's ``end = len - k + 1`` rule applied per shard via clipped
local ends.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import scan_kernel
from ..ops.layout import LANES, DeviceHaystack
from ..ops.scan_math import SENTINEL
from .mesh import DATA_AXIS, NEEDLE_AXIS, corpus_sharding, table_sharding


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=64)
def _sharded_call(mesh: Mesh, s: int, shard_bytes: int, fits32: bool):
    """Sharded find.  ``ends`` arrive as a (n_data, n_pad) int32 matrix of
    shard-LOCAL valid-position bounds (``clip(end_global - shard_base, 0,
    shard_bytes)``, computed in int64 on host) so the kernel and the
    reduction never need a global int32 offset.

    The global first match is the lexicographic min over (shard index,
    local offset): two int32 ``pmin``s.  With ``fits32`` (global positions
    fit int32) the combine ``shard * shard_bytes + local`` happens on device
    and the output matches round 1's API; otherwise the (2, n) component
    pair is returned for the int64 host combine."""

    def local_fn(pw_l, vals_l, msks_l, ends_l):
        shard = jax.lax.axis_index(DATA_AXIS).astype(jnp.int32)
        local = scan_kernel.find_raw(vals_l, msks_l, pw_l, s)
        has = local < ends_l.reshape(-1)
        # The collectives of the whole workload (one int32 per needle
        # each): winning shard index, then the winner's local offset.
        key = jnp.where(has, shard, jnp.int32(SENTINEL))
        kmin = jax.lax.pmin(key, DATA_AXIS)
        lo = jnp.where(
            jnp.logical_and(has, key == kmin), local, jnp.int32(SENTINEL)
        )
        lmin = jax.lax.pmin(lo, DATA_AXIS)
        if fits32:
            return jnp.where(
                kmin < SENTINEL, kmin * shard_bytes + lmin, SENTINEL
            )
        return jnp.stack([kmin, lmin])

    return _shard_jit(mesh, local_fn, fits32)


@functools.lru_cache(maxsize=64)
def _sharded_count_call(mesh: Mesh, s: int, fits32: bool):
    """Distributed occurrence count: local count per shard (valid-position
    bound applied with shard-LOCAL ends), then a ``psum`` over the data
    axis (exactly-once at shard boundaries follows from positions
    belonging to the shard where the match starts; halo bytes are
    read-only context).  Per-shard counts always fit int32 (a shard holds
    < 2^31 positions); when the GLOBAL total might not (``not fits32``) the
    psum runs on two int32 limbs (hi = count >> 16, lo = count & 0xffff —
    exact for up to 2^15 shards) and the int64 recombine happens on host."""

    def local_fn(pw_l, vals_l, msks_l, ends_l):
        counts = scan_kernel.count_raw(
            vals_l, msks_l, ends_l.reshape(-1), pw_l, s
        )
        if fits32:
            return jax.lax.psum(counts, DATA_AXIS)
        hi = jax.lax.psum(counts >> 16, DATA_AXIS)
        lo = jax.lax.psum(counts & 0xFFFF, DATA_AXIS)
        return jnp.stack([hi, lo])

    return _shard_jit(mesh, local_fn, fits32)


def _shard_jit(mesh: Mesh, local_fn, fits32: bool):
    """Corpus windows on the data axis, needle tables on the needle axis,
    (data, needle) ends; per-needle results on the needle axis."""
    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None, None),
            P(NEEDLE_AXIS, None),
            P(NEEDLE_AXIS, None),
            P(DATA_AXIS, NEEDLE_AXIS),
        ),
        out_specs=P(NEEDLE_AXIS) if fits32 else P(None, NEEDLE_AXIS),
        # pallas_call out_shapes don't carry vma annotations.
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_find_cols(
    dh: DeviceHaystack,
    values,
    masks,
    ends,
    mesh: Mesh,
    mode: str = "find",
    force_int64: bool = False,
):
    """Exact global first-match offsets of N needles over a segment-sharded
    corpus on ``mesh`` (``mode="count"``: overlapping occurrence counts
    instead, reduced with ``psum``).

    Returns a device int32 array (SENTINEL where absent) when global
    positions fit int32 — round 1's API — and a host int64 ndarray (-1 where
    absent) for corpora past the 2 GiB int32 range, where the final
    ``shard * shard_bytes + local`` combine must widen.  ``ends`` are global
    (int64-safe) per-needle bounds; the kernels only see shard-local clipped
    int32 ends.

    Tables may mix probe widths: every slot compares under its mask, and
    all-zero padding rows (end 0) report nothing.  Device-resident tables
    stay on device.

    ``force_int64`` forces the >2 GiB component-pair path on any corpus so
    tests can exercise it without materializing gigabytes.
    """
    if not dh.tiled:
        raise ValueError("sharded scan requires a tiled (cols) layout")
    pw = dh.windows()
    g, rows, lanes = pw.shape
    assert lanes == LANES
    # Global ends in int64 (corpora past 2 GiB overflow int32); the kernels
    # only ever see the shard-local clipped int32 matrix built below.
    ends64 = np.asarray(ends, dtype=np.int64)
    masks = jnp.asarray(masks, jnp.uint32)
    # Kernels use the 2-op (w & m) == v compare; re-mask defensively in case
    # a caller-built table is not pre-masked (build_probe_table tables are).
    values = jnp.asarray(values, jnp.uint32) & masks
    n, t = values.shape
    if 4 * (t - 1) + dh.s > rows:
        raise ValueError(
            f"probe table width {t} needs {4 * t - 1} halo bytes, layout "
            f"has {dh.kh}"
        )
    n_data = mesh.shape[DATA_AXIS]
    g_pad = _round_up(g, n_data)
    if g_pad != g:
        # All-pad segments: their positions lie beyond every needle's end.
        pw = jnp.pad(pw, ((0, g_pad - g), (0, 0), (0, 0)))
    seg = dh.s * LANES
    shard_bytes = (g_pad // n_data) * seg
    if shard_bytes > SENTINEL:
        raise ValueError(
            f"shard of {shard_bytes} bytes exceeds the int32 device-offset "
            "range; use more data-axis shards (or smaller segments)"
        )
    # Device offsets are shard-local int32; the combined global offset rides
    # int32 on device only when the whole (padded) corpus fits.
    fits32 = g_pad * seg <= SENTINEL and not force_int64
    n_pad = scan_kernel.plan_block(n, mesh.shape[NEEDLE_AXIS])
    if n_pad != n:
        values = jnp.pad(values, ((0, n_pad - n), (0, 0)))
        masks = jnp.pad(masks, ((0, n_pad - n), (0, 0)))
        ends64 = np.pad(ends64, ((0, n_pad - n),))  # end 0: never matches
    # Shard-local valid-position bounds: clip(end_global - shard_base, 0,
    # shard_bytes) — int64 host math, int32 on device by construction.
    bases = np.arange(n_data, dtype=np.int64) * shard_bytes
    ends2d = np.clip(
        ends64[None, :] - bases[:, None], 0, shard_bytes
    ).astype(np.int32)
    if mode == "find":
        run = _sharded_call(mesh, dh.s, shard_bytes, fits32)
    else:
        run = _sharded_count_call(mesh, dh.s, fits32)
    pw = jax.device_put(pw, corpus_sharding(mesh))
    values = jax.device_put(values, table_sharding(mesh))
    masks = jax.device_put(masks, table_sharding(mesh))
    ends2d = jax.device_put(
        ends2d, NamedSharding(mesh, P(DATA_AXIS, NEEDLE_AXIS))
    )
    out = run(pw, values, masks, ends2d)
    if fits32:
        return out[:n]
    # int64 host combine of the two int32 components (one tiny readback —
    # a corpus this size dwarfs it).
    pair = _to_host(out).astype(np.int64)[:, :n]
    if mode == "find":
        kmin, lmin = pair
        return np.where(kmin < SENTINEL, kmin * shard_bytes + lmin, -1)
    hi, lo = pair
    return (hi << 16) + lo


def sharded_count_cols(
    dh: DeviceHaystack,
    values,
    masks,
    ends,
    mesh: Mesh,
    force_int64: bool = False,
):
    """Overlapping occurrence counts over a segment-sharded corpus — the
    count analogue of :func:`sharded_find_cols` (device int32 when the
    corpus fits int32 positions, host int64 ndarray past 2 GiB)."""
    return sharded_find_cols(
        dh, values, masks, ends, mesh, mode="count", force_int64=force_int64
    )


def _to_host(arr) -> np.ndarray:
    """Fetch a (possibly multi-process) device array to host."""
    if jax.process_count() > 1 and not arr.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
    return np.asarray(arr)


@functools.lru_cache(maxsize=32)
def _sharded_bitmap_call(mesh: Mesh, s: int, n_pad: int, t: int):
    """Sharded all-occurrence bitmap: the XLA bitmap op under shard_map,
    corpus segments on the data axis AND needle rows on the needle axis —
    each (needle block, data shard) pair computes only its own bitmap
    block, so a 2-D mesh does no redundant vector work (r3's replicated
    formulation cost n_needle x; VERDICT r3 item 7).  Ends arrive
    shard-LOCAL (clipped int32, like the find/count paths); padded needle
    rows carry end 0 and decode to nothing."""
    from ..ops import xla_backend

    def local_fn(cols_l, vals, msks, ends_l):
        return xla_backend._match_bitmap_batched_impl(
            cols_l, vals, msks, ends_l.reshape(-1), s
        )

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None, None),
            P(NEEDLE_AXIS, None),
            P(NEEDLE_AXIS, None),
            P(DATA_AXIS, NEEDLE_AXIS),
        ),
        out_specs=P(NEEDLE_AXIS, DATA_AXIS, None, None),
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=32)
def _sharded_compact_call(mesh: Mesh, s: int, n_pad: int, t: int, cap: int):
    """Sharded sparse-positions compaction: per (needle block, data shard)
    the compact scan returns each needle's shard-local count and its
    ``cap`` earliest shard-local offsets — ``cap`` words of readback per
    (needle, shard) instead of the bitmap's shard/8 bytes.  Same 2-D
    (data, needle) decomposition as the bitmap call."""
    from ..ops import xla_backend

    def local_fn(cols_l, vals, msks, ends_l):
        cnt, pos = xla_backend._compact_positions_batched_impl(
            cols_l, vals, msks, ends_l.reshape(-1), s, cap
        )
        return cnt.reshape(-1, 1), pos.reshape(pos.shape[0], 1, cap)

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None, None),
            P(NEEDLE_AXIS, None),
            P(NEEDLE_AXIS, None),
            P(DATA_AXIS, NEEDLE_AXIS),
        ),
        out_specs=(
            P(NEEDLE_AXIS, DATA_AXIS),
            P(NEEDLE_AXIS, DATA_AXIS, None),
        ),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_positions(
    dh: DeviceHaystack,
    values: np.ndarray,
    masks: np.ndarray,
    ends,
    mesh: Mesh,
    sparse_cap: int | None = None,
) -> list:
    """ALL (overlapping) match offsets per needle over a segment-sharded
    corpus: int64[M] ascending per needle — the sharded ``find_iter``
    capability (single-device analogue: ops/xla_backend.match_bitmap_*).

    Two-tier like every other positions path (r5): each shard first
    COMPACTS each needle's matches to its ``sparse_cap`` earliest
    shard-local offsets (cap words of readback per (needle, shard));
    (needle, shard) cells whose count exceeds the cap fall back to the
    per-shard packed bitmap.  Shard-local clipped ends keep matches
    exactly-once at boundaries; offsets combine with the shard's int64
    global base, so corpora past 2 GiB report exact offsets.  In a
    multi-process run each process decodes only its addressable shards
    (callers gather across hosts if a global list is needed)."""
    if not dh.tiled:
        raise ValueError("sharded positions require a tiled (cols) layout")
    from ..ops import xla_backend

    if sparse_cap is None:
        sparse_cap = xla_backend.SPARSE_POSITIONS_CAP

    cols = dh.require_cols()
    g = cols.shape[0]
    n_data = mesh.shape[DATA_AXIS]
    g_pad = _round_up(g, n_data)
    if g_pad != g:
        cols = jnp.pad(cols, ((0, g_pad - g), (0, 0), (0, 0)))
    seg = dh.s * LANES
    shard_bytes = (g_pad // n_data) * seg
    if shard_bytes > SENTINEL:
        raise ValueError(
            f"shard of {shard_bytes} bytes exceeds the int32 device-offset "
            "range; use more data-axis shards (or smaller segments)"
        )
    values = np.asarray(values, np.uint32)
    masks = np.asarray(masks, np.uint32)
    values = values & masks
    n, t = values.shape
    if 4 * t - 1 > dh.kh:
        # Same halo-sufficiency contract as the find/count paths (the bitmap
        # op reads packed windows up to row 4*(t-1)+3 past each segment).
        raise ValueError(
            f"probe table width {t} needs {4 * t - 1} halo bytes, layout "
            f"has {dh.kh}"
        )
    ends64 = np.asarray(ends, dtype=np.int64)
    bases = np.arange(n_data, dtype=np.int64) * shard_bytes
    # Needle rows split across the needle mesh axis (padded rows get end 0,
    # which masks every position — the kernel paths' padding convention).
    n_needle = mesh.shape[NEEDLE_AXIS]
    n_pad = _round_up(n, n_needle)
    rowpad = ((0, n_pad - n), (0, 0))
    values = np.pad(values, rowpad)
    masks = np.pad(masks, rowpad)
    ends64 = np.pad(ends64, ((0, n_pad - n),))
    ends2d = np.clip(
        ends64[None, :] - bases[:, None], 0, shard_bytes
    ).astype(np.int32)
    ends2d[:, n:] = 0

    cols = jax.device_put(cols, corpus_sharding(mesh))
    vals_d = jax.device_put(
        jnp.asarray(values), NamedSharding(mesh, P(NEEDLE_AXIS, None))
    )
    msks_d = jax.device_put(
        jnp.asarray(masks), NamedSharding(mesh, P(NEEDLE_AXIS, None))
    )
    ends_d = jax.device_put(
        ends2d, NamedSharding(mesh, P(DATA_AXIS, NEEDLE_AXIS))
    )
    g_local = g_pad // n_data

    parts: dict[int, list] = {i: [] for i in range(n)}
    dense: set[tuple[int, int]] = set()  # (needle, shard) over-cap cells

    # --- sparse tier: compacted per-(needle, shard) offsets ---------------
    runc = _sharded_compact_call(mesh, dh.s, n_pad, t, int(sparse_cap))
    counts, pos = runc(cols, vals_d, msks_d, ends_d)
    # counts (n_pad, n_data); pos (n_pad, n_data, cap) — read per
    # addressable shard (each process handles only its own blocks).
    seen: set[tuple[int, int]] = set()
    sparse_cells: dict[tuple[int, int], np.ndarray] = {}
    for shard in pos.addressable_shards:
        i0 = shard.index[0].start or 0
        d0 = shard.index[1].start or 0
        if (i0, d0) in seen:
            continue
        seen.add((i0, d0))
        pi = np.asarray(shard.data)  # (n_local, d_local, cap)
        for j in range(pi.shape[0]):
            if i0 + j >= n:
                break
            for dd in range(pi.shape[1]):
                sparse_cells[(i0 + j, d0 + dd)] = pi[j, dd]
    cnt_host: dict[tuple[int, int], int] = {}
    seen.clear()
    for shard in counts.addressable_shards:
        i0 = shard.index[0].start or 0
        d0 = shard.index[1].start or 0
        if (i0, d0) in seen:
            continue
        seen.add((i0, d0))
        ci = np.asarray(shard.data)
        for j in range(ci.shape[0]):
            if i0 + j >= n:
                break
            for dd in range(ci.shape[1]):
                cnt_host[(i0 + j, d0 + dd)] = int(ci[j, dd])
    shard_cells: dict[int, list] = {i: [] for i in range(n)}
    for (i, d), c in cnt_host.items():
        if c > sparse_cap:
            dense.add((i, d))
            continue
        if c:
            cell = sparse_cells[(i, d)][:c].astype(np.int64)
            shard_cells[i].append((d, cell + d * shard_bytes))

    # Multi-controller alignment: the dense-tier DISPATCH must run on
    # every process or none (jit over globally-sharded arrays is SPMD) —
    # decide from the GLOBAL counts, which every process reduces
    # identically, never from process-local addressable cells.
    any_dense = bool(
        np.asarray(jax.jit(lambda c: jnp.any(c > sparse_cap))(counts))
    )

    # --- dense tier: per-shard bitmap for over-cap cells ------------------
    if any_dense:
        run = _sharded_bitmap_call(mesh, dh.s, n_pad, t)
        words = run(cols, vals_d, msks_d, ends_d)
        seen.clear()
        for shard in sorted(
            words.addressable_shards,
            key=lambda sh: (sh.index[0].start or 0, sh.index[1].start or 0),
        ):
            i0 = shard.index[0].start or 0
            g0 = shard.index[1].start or 0
            if (i0, g0) in seen:
                continue
            seen.add((i0, g0))
            d = g0 // g_local
            rows = [
                j for j in range(min(shard.data.shape[0], n - i0))
                if (i0 + j, d) in dense
            ]
            if not rows:
                continue
            wi = np.asarray(shard.data)  # (n_local, g_local, s/32, 128)
            base = d * shard_bytes
            for j in rows:
                local = xla_backend.decode_match_bitmap(wi[j], dh.s)
                shard_cells[i0 + j].append((d, local + base))

    for i in range(n):
        for _, cell in sorted(shard_cells[i], key=lambda x: x[0]):
            if cell.size:
                parts[i].append(cell)
    return [
        np.concatenate(parts[i]) if parts[i] else np.empty((0,), np.int64)
        for i in range(n)
    ]


class ShardedBatchedSearcher:
    """BatchedSearcher over a device mesh: same API, sharded execution.

    Probe tables and the sharded corpus are placed on the mesh once and
    cached (keyed by corpus identity), so repeated sweeps issue no
    device_put traffic — the multi-chip analogue of the single-chip fused
    sweep's pre-padded device tables."""

    def __init__(self, needles, mesh: Mesh, position=None):
        from ..models.batched import BatchedSearcher

        # Needles beyond MAX_NEEDLE_LEN ride the filter+verify fallback
        # (models/huge.py) distributed over the mesh: the 64-byte prefix
        # filter is the sharded bitmap op, and each PROCESS verifies the
        # candidates whose first byte lies in its local byte range
        # (DeviceHaystack host bytes single-process; GlobalCorpus
        # local_bytes + peek multi-host) — no host ever assembles the
        # corpus.  Reference bar: no needle-length limit (src/lib.rs:52-59).
        self.inner = BatchedSearcher(needles, position)
        self.mesh = mesh
        #: test hook: force the >2 GiB component-pair path on any corpus.
        self.force_int64 = False
        self._placed_tables = None
        self._placed_corpus: dict = {}
        #: huge-needle dense-tier local layouts, keyed by (corpus identity,
        #: peek slice length): repeated dense queries over the same
        #: GlobalCorpus reuse ONE preprocessed local range instead of
        #: re-uploading this process's bytes per call (the serving-pattern
        #: economics every other path caches for — VERDICT r4 item 6).
        self._huge_local_layouts: dict = {}

    _PLACED_CACHE_CAP = 16

    def __len__(self):
        return len(self.inner)

    def _corpus(self, hay):
        """Resolve the input to a scannable corpus: DeviceHaystack / bytes
        go through the batched layout (halo sized for the needle set);
        duck-typed global corpora (parallel.distributed.GlobalCorpus) are
        used as-is after a halo check — relayout would require assembling
        the corpus on one host, which multi-host deliberately never does."""
        if isinstance(hay, DeviceHaystack) or not hasattr(hay, "windows"):
            return self.inner._layout(hay)
        need = max(4 * self.inner.max_t - 1, 3)
        if self.inner._huge:
            from ..models.huge import PREFIX_LEN

            # The huge-needle prefix filter probes PREFIX_LEN bytes.
            need = max(need, PREFIX_LEN - 1)
        if hay.kh < need:
            raise ValueError(
                f"global corpus halo kh={hay.kh} < required {need}; "
                "assemble with a larger kh for this needle set"
            )
        return hay

    def _tables(self, hay_len: int):
        tabs = []
        for grp in self.inner.groups:
            grp.sync_host()  # device-side reorders materialize lazily
            # Ends stay HOST int64 (global bounds past 2 GiB don't fit
            # int32); sharded_find_cols clips them to per-shard int32.
            ends64 = np.maximum(
                np.int64(hay_len) - grp.lengths.astype(np.int64) + 1, 0
            )
            ends64 = np.pad(ends64, ((0, grp.n_pad - grp.n),))
            tabs.append(
                (
                    jax.device_put(grp.values_dev, table_sharding(self.mesh)),
                    jax.device_put(grp.masks_dev, table_sharding(self.mesh)),
                    ends64,
                )
            )
        return tabs

    def _run_groups(
        self, dh: DeviceHaystack, fn, remap_sentinel: bool
    ) -> np.ndarray:
        """Run ``fn(dh, values, masks, ends, mesh)`` per width group and
        scatter results to input order (device scatter on the int32 path,
        host int64 scatter past 2 GiB).  ``remap_sentinel``: map the device
        path's SENTINEL to -1 (find semantics; counts are left as-is)."""
        dh = self._corpus(dh)
        n = len(self.inner)
        pw = dh.windows()  # corpus identity = the packed-window array
        # Keyed by corpus identity AND the inner searcher's epoch: an
        # optimize_for() permutes group rows, so stale placed tables would
        # pair old row order with new indices.
        key = (id(pw), self.inner._epoch)
        hit = self._placed_corpus.get(key)
        if hit is None or hit[0]() is not pw:
            # FIFO capacity like the single-chip _sweep_cache: a serving loop
            # alternating several corpora re-places nothing after warmup.
            # Entries hold only a WEAK ref to pw — the cache must never pin
            # a dropped corpus's packed windows (~4 bytes/corpus-byte) in
            # HBM; a dead ref also flags id-reuse, so a recycled id can
            # never pair a new corpus with stale tables.
            import weakref

            self._placed_corpus[key] = (weakref.ref(pw), self._tables(dh.length))
            for k in [
                k for k, v in self._placed_corpus.items() if v[0]() is None
            ]:
                del self._placed_corpus[k]
            while len(self._placed_corpus) > self._PLACED_CACHE_CAP:
                self._placed_corpus.pop(next(iter(self._placed_corpus)))
        tabs = self._placed_corpus[key][1]
        parts = []
        blobs = []
        for grp, (v, m, e) in zip(self.inner.groups, tabs):
            parts.append(
                fn(dh, v, m, e, self.mesh, force_int64=self.force_int64)
            )
            blobs.append(grp.indices.tobytes())
        if parts and isinstance(parts[0], np.ndarray):
            # int64 host path: absent is already -1, offsets may exceed
            # SENTINEL legitimately — no remap.
            out = np.empty((n,), np.int64)
            for grp, p in zip(self.inner.groups, parts):
                # Group tables are pre-padded; keep the real rows only.
                out[grp.indices] = p[: len(grp.indices)]
            return out
        from ..models.batched import _scatter_groups

        merged = _scatter_groups(n, tuple(blobs), parts)
        out = np.asarray(merged).astype(np.int64)
        if remap_sentinel:
            out[out >= SENTINEL] = -1  # device int32 path: SENTINEL = absent
        return out

    # -- huge needles: sharded prefix filter + process-local verify ----------

    def _huge_ctx(self, dh) -> tuple:
        """(local_bytes, peek, base, own_end): the bytes this process can
        verify huge-needle candidates against, the global offset of their
        first byte, and the global end of this process's OWNERSHIP (a
        candidate is verified by the process holding its first byte —
        exactly-once, same rule as shard boundaries)."""
        if isinstance(dh, DeviceHaystack):
            if dh.host_bytes is None:
                raise ValueError(
                    "huge-needle search requires host bytes for the verify "
                    "step (preprocess with keep_host=True)"
                )
            return dh.host_bytes, b"", 0, dh.length
        lb = getattr(dh, "local_bytes", None)
        if lb is None:
            raise ValueError(
                "huge-needle search over a GlobalCorpus requires the local "
                "byte range for the verify step; assemble_global_corpus "
                "with keep_local=True"
            )
        peek = getattr(dh, "local_peek", b"")
        base = int(getattr(dh, "local_base", 0))
        return lb, peek, base, min(base + len(lb), dh.length)

    @staticmethod
    def _huge_match_at(lb: bytes, peek: bytes, rel: int, full: bytes) -> bool:
        """memcmp ``full`` at local offset ``rel``, reading into the peek
        for range-straddling candidates (no local+peek concatenation — the
        straddle tail copy is bounded by the needle length)."""
        k = len(full)
        if rel + k <= len(lb):
            return lb[rel : rel + k] == full
        head = lb[rel:]
        tail = k - len(head)
        if tail > len(peek):
            raise ValueError(
                f"huge-needle verify needs {tail} bytes past this process's "
                f"local range but the peek holds {len(peek)}; "
                "assemble_global_corpus with a peek of at least "
                "len(needle) - 1 bytes"
            )
        return head == full[: len(head)] and peek[:tail] == full[len(head) : k]

    def _huge_positions_local(self, dh, first_only: bool = False) -> dict:
        """{needle index: verified global offsets (int64, ascending) whose
        first byte lies in THIS process's range}.  The prefix filter is one
        sharded count pass per huge needle; when the global candidate
        population is small, candidates are decoded and verified against
        this process's bytes (cost proportional to survivors, same economics
        as models/huge.py).  A dense candidate population (adversarial
        prefix repetition) escapes to the device chained-bitmap verify over
        the local range instead — never an O(candidates) host loop
        (models/huge.py dense tier; VERDICT r3 item 4).  ``first_only``
        stops verifying a needle at its first confirmed candidate
        (candidates arrive ascending)."""
        from ..models.huge import HOST_VERIFY_MAX
        from ..needle import build_probe_table

        if not self.inner._huge:
            return {}
        lb, peek, base, own_end = self._huge_ctx(dh)
        out = {}
        for i, hs in self.inner._huge:
            vals, msks, _ = build_probe_table([hs.needle.data])
            k = hs.size
            ends = np.asarray([max(dh.length - k + 1, 0)], np.int64)
            # Global candidate count first (one psum'd pass): the decode
            # readback alone is O(candidates), so the tier decision must
            # precede it.  The count is global, hence identical on every
            # process — all processes take the same branch.
            ncand = int(
                np.asarray(
                    sharded_count_cols(dh, vals, msks, ends, self.mesh)
                ).reshape(-1)[0]
            )
            if ncand > HOST_VERIFY_MAX:
                out[i] = self._huge_dense_local(
                    hs, first_only, lb, peek, base, own_end
                )
                continue
            cands = sharded_positions(dh, vals, msks, ends, self.mesh)[0]
            good = []
            for c in cands:
                c = int(c)
                if not (base <= c < own_end):
                    # Addressable shards ARE this process's contiguous range
                    # (make_array_from_process_local_data): a candidate
                    # outside it means the mesh/device ordering broke that
                    # contract — fail loudly rather than miss a match.
                    raise RuntimeError(
                        f"candidate offset {c} outside this process's range "
                        f"[{base}, {own_end}); mesh device order does not "
                        "match process-contiguous corpus assembly"
                    )
                if self._huge_match_at(lb, peek, c - base, hs._full):
                    good.append(c)
                    if first_only:
                        break
            out[i] = np.asarray(good, np.int64)
        return out

    def _huge_dense_local(
        self, hs, first_only: bool, lb: bytes, peek: bytes, base: int,
        own_end: int,
    ) -> np.ndarray:
        """Dense-tier verify over THIS process's byte range: lay out
        local bytes + (k-1)-byte peek as a local corpus and let the
        huge searcher's tiered verify answer on device; ownership
        (start byte in [base, own_end)) keeps results exactly-once.
        The local layout is memoized per (corpus bytes identity, peek
        slice) so a repeated dense query issues no corpus upload."""
        own = own_end - base
        k = hs.size
        peek_len = min(max(k - 1, 0), len(peek))
        if own <= 0 or len(lb) + peek_len < k:
            return np.empty((0,), np.int64)
        key = (id(lb), id(peek), peek_len)
        hit = self._huge_local_layouts.get(key)
        if hit is not None and hit[0] is lb and hit[1] is peek:
            dhl = hit[2]
        else:
            from ..models.huge import CHUNK
            from ..needle import needed_halo_for_t
            from ..ops.layout import preprocess

            # Lay out with the dense tier's chunk halo up front: the
            # chained-bitmap verify would otherwise relayout (ensure_halo)
            # on first use.
            dhl = preprocess(
                lb + peek[:peek_len], kh=needed_halo_for_t(CHUNK // 4)
            )
            # Strong refs to lb AND peek keep the id() keys stable (bytes
            # cannot be weak-referenced) and make the identity check
            # airtight — a new corpus pairing the same local bytes with a
            # DIFFERENT neighbor peek must not hit this entry.  FIFO
            # capacity bounds what a dead corpus can pin.
            self._huge_local_layouts[key] = (lb, peek, dhl)
            while len(self._huge_local_layouts) > self._PLACED_CACHE_CAP:
                self._huge_local_layouts.pop(
                    next(iter(self._huge_local_layouts))
                )
        if first_only:
            f = hs.find(dhl)
            if f is None or f >= own:
                return np.empty((0,), np.int64)
            return np.asarray([base + f], np.int64)
        pos = hs.positions(dhl)
        return pos[pos < own] + base

    @staticmethod
    def _allgather_rows(vec: np.ndarray) -> np.ndarray:
        """(P, m) stack of a host int64 vector across processes (identity
        single-process; two-limb exact past 2^31 — see allgather_i64)."""
        from .distributed import allgather_i64

        return allgather_i64(vec)

    def _fill_huge_find(self, out: np.ndarray, dh) -> np.ndarray:
        pos = self._huge_positions_local(dh, first_only=True)
        if not pos:
            return out
        idx = sorted(pos)
        local = np.asarray(
            [pos[i][0] if pos[i].size else -1 for i in idx], np.int64
        )
        rows = self._allgather_rows(local)  # (P, n_huge)
        rows = np.where(rows < 0, np.iinfo(np.int64).max, rows)
        first = rows.min(axis=0)
        out[idx] = np.where(first == np.iinfo(np.int64).max, -1, first)
        return out

    def _fill_huge_count(self, out: np.ndarray, dh) -> np.ndarray:
        pos = self._huge_positions_local(dh)
        if not pos:
            return out
        idx = sorted(pos)
        local = np.asarray([pos[i].size for i in idx], np.int64)
        out[idx] = self._allgather_rows(local).sum(axis=0)
        return out

    # -- public API ----------------------------------------------------------

    def find_all(self, dh: DeviceHaystack) -> np.ndarray:
        dh = self._corpus(dh)
        if self.inner.groups:
            out = self._run_groups(dh, sharded_find_cols, remap_sentinel=True)
        else:
            out = np.full((len(self.inner),), -1, np.int64)
        return self._fill_huge_find(out, dh)

    def count_all(self, dh: DeviceHaystack) -> np.ndarray:
        """Overlapping occurrence counts (int64[N]) across the sharded
        corpus — one ``psum`` per query batch."""
        dh = self._corpus(dh)
        if self.inner.groups:
            out = self._run_groups(
                dh, sharded_count_cols, remap_sentinel=False
            )
        else:
            out = np.zeros((len(self.inner),), np.int64)
        return self._fill_huge_count(out, dh)

    def positions_all(
        self, dh: DeviceHaystack, batch: int = 16, gather: bool = False
    ) -> list:
        """ALL (overlapping) match offsets per needle (int64[M] ascending,
        input order) across the sharded corpus — the sharded ``find_iter``
        capability.  ``batch`` bounds bitmap memory (corpus/8 bytes per
        needle per sweep, split across the data shards).

        Multi-process: each process returns offsets decoded from ITS
        addressable shards; ``gather=True`` allgathers them so every
        process returns the complete global lists
        (parallel.distributed.gather_positions)."""
        dh = self._corpus(dh)
        out: list = [None] * len(self.inner)
        for grp in self.inner.groups:
            grp.sync_host()
            vals = grp.values_host  # host copies kept at build time — no
            msks = grp.masks_host   # device->host table readback per call
            ends = np.maximum(
                np.int64(dh.length) - grp.lengths.astype(np.int64) + 1, 0
            )
            for i0 in range(0, grp.n, batch):
                res = sharded_positions(
                    dh,
                    vals[i0 : i0 + batch],
                    msks[i0 : i0 + batch],
                    ends[i0 : i0 + batch],
                    self.mesh,
                )
                for j, r in enumerate(res):
                    out[grp.indices[i0 + j]] = r
        for i, pos in self._huge_positions_local(dh).items():
            out[i] = pos
        if gather:
            from .distributed import gather_positions

            out = gather_positions(out)
        return out

    def optimize_for(self, dh, firsts=None) -> "ShardedBatchedSearcher":
        """Adaptive block scheduling over the mesh (see
        BatchedSearcher.optimize_for): group rows reorder by first offsets
        so blocks retire together on every shard; the epoch bump
        invalidates the placed-table cache.  ``firsts`` from a prior
        ``find_all`` skips the measuring sweep (serving-loop piggyback)."""
        if firsts is None:
            firsts = self.find_all(dh)
        self.inner._apply_schedule(np.asarray(firsts))
        return self

    def search_all(self, dh) -> np.ndarray:
        return self.find_all(dh) >= 0
