"""Dynamic needle-length dispatch — the ``DynamicAvx2Searcher`` analogue
(src/x86.rs:397-526): pick the right specialization at construction time.

Arms: empty needle -> always-true N0 (src/x86.rs:470,500); one byte ->
MemchrSearcher (src/x86.rs:471-475); 2..=16 -> static-offset specialized
kernels (src/x86.rs:476-490); otherwise the generic searcher (src/x86.rs:491).

One extra rung the reference's ladder implies but a device target makes
explicit: haystacks below :data:`HOST_HAY_BYTES` that arrive as host bytes
are searched by the native C++ SWAR tier (utils/native.py) — a device
round trip (upload, launch, readback) costs more than a sub-4KB scan on the
host, the same "cheapest adequate machinery" logic as
the reference's narrow-register rungs (src/x86.rs:361-375).  Preprocessed
:class:`DeviceHaystack` inputs always take the device path.
"""

from __future__ import annotations

from typing import Optional

from ..needle import MAX_NEEDLE_LEN, NeedleLike, as_bytes
from ..ops.layout import DeviceHaystack
from ..searcher import EmptyNeedleSearcher, HaystackLike, _hay_bytes
from .memchr import MemchrSearcher
from .naive import naive_find
from .pallas_searcher import searcher_for_size

#: Host-bytes haystacks at or below this size skip the device entirely.
HOST_HAY_BYTES = 4096


class DynamicSearcher:
    def __init__(self, needle: NeedleLike, position: Optional[int] = None):
        data = as_bytes(needle)
        #: full needle bytes — for huge needles ``_inner.needle.data`` holds
        #: only the device-filter prefix, so host rungs read this instead.
        self._data = data
        k = len(data)
        if k == 0:
            if position not in (None, 0):
                raise ValueError("invalid position for empty needle")
            self._inner = EmptyNeedleSearcher()
        elif k == 1:
            self._inner = MemchrSearcher(data, position)
        elif k > MAX_NEEDLE_LEN:
            # Arbitrary-length parity with the reference (src/lib.rs:52-59):
            # device prefix filter + host verify (models/huge.py).
            from .huge import HugeNeedleSearcher

            self._inner = HugeNeedleSearcher(data, position)
        else:
            self._inner = searcher_for_size(k)(data, position)

    @classmethod
    def with_position(cls, needle: NeedleLike, position: int):
        return cls(needle, position)

    @property
    def inner(self):
        return self._inner

    @property
    def size(self) -> int:
        return self._inner.size

    @property
    def position(self) -> int:
        return self._inner.position

    def search_in(self, hay: HaystackLike) -> bool:
        return self.find(hay) is not None

    def find(self, hay: HaystackLike) -> Optional[int]:
        if self._inner.size and not isinstance(hay, DeviceHaystack):
            data = _hay_bytes(hay)
            if len(data) <= HOST_HAY_BYTES:
                return self._host_find(data)
        return self._inner.find(hay)

    inlined_search_in = search_in

    def count_in(self, hay: HaystackLike) -> int:
        """Overlapping occurrence count (capability extension; see
        ``SearcherBase.count_in``)."""
        if self._inner.size and not isinstance(hay, DeviceHaystack):
            data = _hay_bytes(hay)
            if len(data) <= HOST_HAY_BYTES:
                from ..searcher import overlapping_count

                return overlapping_count(data, self._data)
        return self._inner.count_in(hay)

    def positions(self, hay: HaystackLike):
        """All (overlapping) match offsets, ascending (capability
        extension; see ``SearcherBase.positions``)."""
        if self._inner.size and not isinstance(hay, DeviceHaystack):
            data = _hay_bytes(hay)
            if len(data) <= HOST_HAY_BYTES:
                from ..searcher import _host_positions

                return _host_positions(data, self._data)
        return self._inner.positions(hay)

    def find_iter(self, hay: HaystackLike):
        return iter(self.positions(hay).tolist())

    def _host_find(self, data: bytes) -> Optional[int]:
        from ..utils import native

        if native.available():
            return native.swar_find(data, self._data, self._inner.position)
        return naive_find(data, self._data)

    def __repr__(self):
        return f"DynamicSearcher({self._inner!r})"
