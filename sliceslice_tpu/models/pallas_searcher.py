"""The native searcher family: Pallas kernels behind the reference's
``Avx2Searcher``-shaped API (src/x86.rs:266-395).

Like the reference's per-haystack-length vector ladder (src/x86.rs:361-375),
``PallasSearcher`` dispatches on haystack size: trivial lengths short-circuit,
short haystacks take the flat XLA rung (narrow-vector analogue), and long
haystacks run the tiled Pallas scan kernel (the AVX2-width rung).

The per-size specialized classes (``Searcher2`` .. ``Searcher16``) are the
analogue of the ``Avx2Searcher<[u8; k]>`` const-specialized verify arms
N2..N16 (src/x86.rs:411-439): each pins its needle length and compiles a
kernel whose probe-table width is exactly ``ceil(k/4)`` (probe offsets are
already static per slot for every searcher — see needle.probe_program — so
specialization here means minimal probe slots and a pinned-length contract).
"""

from __future__ import annotations

import numpy as np

from ..needle import probe_program
from ..ops import scan_kernel, xla_backend
from ..ops.layout import DeviceHaystack
from ..searcher import SearcherBase

#: Needle lengths with a dedicated specialized class (reference N2..N16).
SPECIALIZED_SIZES = tuple(range(2, 17))


class PallasSearcher(SearcherBase):
    """Generic single-needle searcher (the reference's fallback ``N`` arm)."""

    def __init__(self, needle, position=None):
        super().__init__(needle, position)
        if self.needle.size == 0:
            raise ValueError(
                "empty needle (reference: Avx2Searcher::new panics, "
                "src/x86.rs:300)"
            )
        vals, msks = probe_program(self.needle.data)
        self._values = np.asarray([vals], np.uint32)
        self._masks = np.asarray([msks], np.uint32)

    def _find_device(self, dh: DeviceHaystack):
        k = self.needle.size
        end = dh.length - k + 1
        if not dh.tiled:
            return xla_backend.find_flat(
                dh.flat, self._values[0], self._masks[0], end
            )
        dh = dh.ensure_kh(k)
        return scan_kernel.batched_find_cols(
            None, self._values, self._masks, np.asarray([end], np.int32),
            s=dh.s, pw=dh.windows(),
        )[0]

    def _count_device(self, dh: DeviceHaystack):
        k = self.needle.size
        end = dh.length - k + 1
        if not dh.tiled:
            raise NotImplementedError  # flat layout: host fallback
        dh = dh.ensure_kh(k)
        return scan_kernel.batched_count_cols(
            None, self._values, self._masks, np.asarray([end], np.int32),
            s=dh.s, pw=dh.windows(),
        )[0]


def _make_specialized(k: int):
    class _Specialized(PallasSearcher):
        def __init__(self, needle, position=None):
            super().__init__(needle, position)
            if self.needle.size != k:
                raise ValueError(
                    f"{type(self).__name__} requires needle length {k}, got "
                    f"{self.needle.size} (reference SIZE/len assert, "
                    "src/x86.rs:303-305)"
                )

    _Specialized.__name__ = f"Searcher{k}"
    _Specialized.__qualname__ = f"Searcher{k}"
    return _Specialized


#: SearcherK classes for k in 2..=16 — the reference's N2..N16 family.
SPECIALIZED = {k: _make_specialized(k) for k in SPECIALIZED_SIZES}


def searcher_for_size(k: int):
    """Class implementing the specialization for needle length k (generic
    PallasSearcher when no dedicated variant exists)."""
    return SPECIALIZED.get(k, PallasSearcher)
