"""Huge-needle searcher: needles beyond the generic kernels' probe-table
budget (``MAX_NEEDLE_LEN``), supported exactly via filter + verify.

The reference accepts arbitrary-length needles through one generic path
(src/lib.rs:52-59) because its filter is only ever two bytes wide and the
verify is a serial memcmp (src/lib.rs:199-251).  The device kernels instead
verify *in-kernel* with a probe table whose width scales with the needle —
bounded by the layout's halo rows.  Past that bound this searcher restores the
reference's filter+verify split at a coarser grain, with an adaptive verify
tier:

* **filter (device)** — scan for the needle's first ``PREFIX_LEN`` bytes
  with the device count/bitmap ops (one full-bandwidth pass).  A 64-byte
  prefix is a vastly stronger filter than the reference's 2-byte first/last
  hash, so candidates are rare by construction;
* **sparse verify (host)** — when the device-counted candidate population is
  at most ``HOST_VERIFY_MAX``, memcmp the full needle at each candidate
  against the retained host bytes (libc speed, work proportional to the
  survivors);
* **dense verify (device)** — when candidates are dense (adversarial
  repetition of the prefix — the case that degrades candidate-verify schemes
  to O(len*k) host work), switch to the chained-bitmap verify
  (ops/xla_backend.chained_match_bitmap): the needle is split into
  ``CHUNK``-byte sub-tables, each scanned into a packed match bitmap, and
  the bitmaps are AND-combined at word-aligned shifts on device.  Identical
  chunks share one bitmap pass, so periodic adversarial needles cost ~one
  scan; fully aperiodic dense cases cost ceil(k/4) probe passes of dense
  vector work — branch-free and device-resident either way.

All three tiers are exact for find/count/positions.  The DoS-hardening knob
``with_position`` exists in the reference precisely because its 2-byte
filter is cheap to saturate (src/x86.rs:252-255); here saturating the
64-byte prefix merely selects the dense tier, which is the same dense
evaluation the normal kernels always do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..needle import (
    MAX_NEEDLE_LEN,
    Needle,
    NeedleLike,
    as_bytes,
    build_probe_table,
)
from ..ops.layout import SHORT_HAY_BYTES, DeviceHaystack
from ..searcher import HaystackLike, SearcherBase, _hay_bytes, _host_positions

#: Device-filter prefix width: 16 probe slots (the unrolled-kernel budget is
#: irrelevant here — the bitmap op chains any static width), chosen to fit
#: the default layout halo (needed_halo(64) = 63 <= DEFAULT_KH) so a
#: default-preprocessed haystack needs no relayout.
PREFIX_LEN = 64

#: Chunk width of the dense (chained-bitmap) verify tier.  A multiple of 32
#: (chunk offsets must be word-aligned bit shifts of the packed bitmaps) with
#: a modest halo requirement (needed_halo_for_t(128) = 511 bytes -> 512 halo
#: rows, ~12% of a max-size segment).
CHUNK = 512

#: Candidate budget of the sparse (host-memcmp) verify tier.  At ~1 us per
#: candidate, the host tier costs at most ~20 ms; past that the dense device
#: tier wins even for multi-chunk needles.
HOST_VERIFY_MAX = 16384


class HugeNeedleSearcher(SearcherBase):
    """Exact searcher for needles longer than ``MAX_NEEDLE_LEN``."""

    def __init__(self, needle: NeedleLike, position: Optional[int] = None):
        data = as_bytes(needle)
        k = len(data)
        if k <= MAX_NEEDLE_LEN:
            raise ValueError(
                f"HugeNeedleSearcher is for needles > {MAX_NEEDLE_LEN} bytes"
            )
        if position is None:
            position = k - 1
        if not (0 <= position < k):
            raise ValueError(
                f"invalid position {position} for needle of length {k} "
                "(reference contract: position < needle.size(), src/x86.rs:300)"
            )
        # The device filter runs on the prefix; full bytes live here.
        self.needle = Needle(data[:PREFIX_LEN], min(position, PREFIX_LEN - 1))
        self._full = data
        self._position = position
        self._chunk_plan_cache = None

    @property
    def size(self) -> int:
        return len(self._full)

    @property
    def position(self) -> int:
        return self._position

    # -- candidate machinery --------------------------------------------------

    def _as_layout(self, hay: HaystackLike):
        """(DeviceHaystack | None, host bytes | None): tiled layouts return a
        DeviceHaystack; small/flat haystacks return host bytes only."""
        if isinstance(hay, DeviceHaystack):
            if hay.tiled:
                return hay, hay.host_bytes
            if hay.host_bytes is None:
                raise ValueError(
                    "huge-needle search on a flat DeviceHaystack requires "
                    "host bytes (preprocess with keep_host=True)"
                )
            return None, hay.host_bytes
        data = _hay_bytes(hay)
        if len(data) <= max(SHORT_HAY_BYTES, len(self._full)):
            return None, data
        return self._layout(data), data

    def _candidate_count(self, dh: DeviceHaystack) -> int:
        """Device count of prefix-filter survivors (one scan, scalar read)."""
        return _prefix_searcher(self.needle).count_in(dh)

    def _host_candidates(self, dh: DeviceHaystack) -> np.ndarray:
        """Ascending candidate offsets (sparse tier only — the caller has
        already verified the count is <= HOST_VERIFY_MAX, so the compact
        scan is exact and reads back HOST_VERIFY_MAX words instead of the
        corpus/8-byte bitmap)."""
        from ..needle import probe_program
        from ..ops import xla_backend

        pk = self.needle.size
        dh2 = dh.ensure_kh(pk)
        values, masks = probe_program(self.needle.data)
        _, pos = xla_backend.compact_positions(
            dh2.require_cols(), values, masks, dh2.length - pk + 1,
            dh2.s, HOST_VERIFY_MAX,
        )
        pos = np.asarray(pos)
        from ..ops.scan_math import SENTINEL

        return pos[pos < SENTINEL].astype(np.int64)

    def _dense(self, dh: DeviceHaystack):
        """Dense tier: device (count, first, words) over the chained bitmap."""
        from ..ops import xla_backend

        uniq_tables, uniq_lens, chunk_map, offsets = self._chunk_plan()
        from ..needle import needed_halo_for_t

        dh2 = dh.ensure_halo(needed_halo_for_t(CHUNK // 4))
        return (
            xla_backend.chained_match_bitmap(
                dh2.windows(), uniq_tables, uniq_lens, chunk_map,
                offsets, dh2.length, dh2.s,
            ),
            dh2,
        )

    def _chunk_plan(self):
        """Split the needle into CHUNK-byte sub-tables, deduplicating
        identical chunks (periodic needles collapse to ~one table)."""
        if self._chunk_plan_cache is None:
            uniq: dict[bytes, int] = {}
            chunk_map = []
            offsets = []
            for o in range(0, len(self._full), CHUNK):
                cb = self._full[o : o + CHUNK]
                if cb not in uniq:
                    uniq[cb] = len(uniq)
                chunk_map.append(uniq[cb])
                offsets.append(o)
            tables = []
            lens = []
            for cb in uniq:  # insertion order
                vals, msks, _ = build_probe_table([cb])
                tables.append((vals[0], msks[0]))
                lens.append(len(cb))
            self._chunk_plan_cache = (
                tuple(tables), tuple(lens), tuple(chunk_map), tuple(offsets)
            )
        return self._chunk_plan_cache

    def _route(
        self,
        dh: Optional[DeviceHaystack],
        data: Optional[bytes],
        ncand: Optional[int] = None,
    ):
        """('empty'|'host'|'dense', payload) — the three-tier decision.
        ``ncand``: precomputed device candidate count (streaming batches
        ONE prefix-count scan + readback across all huge needles per
        window instead of one per needle)."""
        if dh is None:
            return "hostscan", data
        if dh.length < len(self._full):
            return "empty", None
        if ncand is None:
            ncand = self._candidate_count(dh)
        if ncand == 0:
            return "empty", None
        if ncand <= HOST_VERIFY_MAX and data is not None:
            return "host", self._host_candidates(dh)
        return "dense", None

    # -- public API (SearcherBase signatures) ---------------------------------

    def find(self, hay: HaystackLike) -> Optional[int]:
        dh, data = self._as_layout(hay)
        return self._find_tiers(dh, data, self._route(dh, data))

    def find_with_candidates(self, dh: DeviceHaystack, ncand: int):
        """``find`` over a tiled layout with the prefix-candidate count
        already known (streaming's batched filter)."""
        data = dh.host_bytes
        return self._find_tiers(dh, data, self._route(dh, data, ncand))

    def _find_tiers(self, dh, data, route) -> Optional[int]:
        tier, payload = route
        if tier == "empty":
            return None
        if tier == "hostscan":
            p = data.find(self._full)
            return None if p < 0 else p
        if tier == "host":
            k = len(self._full)
            for c in payload:
                if data[c : c + k] == self._full:
                    return int(c)
            return None
        (count, first, _), _ = self._dense(dh)
        f = int(first)
        from ..ops.scan_math import SENTINEL

        return None if f >= SENTINEL else f

    def count_in(self, hay: HaystackLike) -> int:
        dh, data = self._as_layout(hay)
        return self._count_tiers(dh, data, self._route(dh, data))

    def count_with_candidates(self, dh: DeviceHaystack, ncand: int) -> int:
        data = dh.host_bytes
        return self._count_tiers(dh, data, self._route(dh, data, ncand))

    def _count_tiers(self, dh, data, route) -> int:
        tier, payload = route
        if tier == "empty":
            return 0
        if tier == "hostscan":
            from ..searcher import overlapping_count

            return overlapping_count(data, self._full)
        if tier == "host":
            k = len(self._full)
            return sum(
                1 for c in payload if data[c : c + k] == self._full
            )
        (count, _, _), _ = self._dense(dh)
        return int(count)

    def positions(self, hay: HaystackLike) -> np.ndarray:
        dh, data = self._as_layout(hay)
        return self._positions_tiers(dh, data, self._route(dh, data))

    def positions_with_candidates(
        self, dh: DeviceHaystack, ncand: int
    ) -> np.ndarray:
        data = dh.host_bytes
        return self._positions_tiers(dh, data, self._route(dh, data, ncand))

    def _positions_tiers(self, dh, data, route) -> np.ndarray:
        tier, payload = route
        if tier == "empty":
            return np.empty((0,), np.int64)
        if tier == "hostscan":
            return _host_positions(data, self._full)
        if tier == "host":
            k = len(self._full)
            out = [int(c) for c in payload if data[c : c + k] == self._full]
            return np.asarray(out, dtype=np.int64)
        from ..ops import xla_backend

        (_, _, words), dh2 = self._dense(dh)
        return xla_backend.decode_match_bitmap(np.asarray(words), dh2.s)


def _prefix_searcher(prefix_needle: Needle):
    """A plain generic searcher over the prefix bytes (its count/positions
    drive the candidate filter)."""
    from .pallas_searcher import searcher_for_size

    cls = searcher_for_size(prefix_needle.size)
    return cls(prefix_needle.data, prefix_needle.position)
