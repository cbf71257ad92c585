"""Single-byte searcher — the ``MemchrSearcher`` analogue (src/lib.rs:119-142):
a dedicated 1-byte path that compares the raw uint8 tiles directly (no window
packing) in one fused XLA reduction."""

from __future__ import annotations

import numpy as np

from ..needle import probe_program
from ..ops import scan_kernel, xla_backend
from ..ops.layout import DeviceHaystack
from ..searcher import SearcherBase


class MemchrSearcher(SearcherBase):
    def __init__(self, needle, position=None):
        super().__init__(needle, position)
        if self.needle.size != 1:
            raise ValueError(
                f"MemchrSearcher requires a 1-byte needle, got {self.needle.size}"
            )
        self._byte = self.needle.data[0]

    def _find_device(self, dh: DeviceHaystack):
        end = dh.length  # end = len - k + 1 with k = 1
        if not dh.tiled:
            vals, msks = probe_program(self.needle.data)
            return xla_backend.find_flat(dh.flat, vals, msks, end)
        return scan_kernel.memchr_find_cols(
            dh.require_cols(), self._byte, end, s=dh.s
        )

    def _count_device(self, dh: DeviceHaystack):
        if not dh.tiled:
            raise NotImplementedError  # flat layout: host fallback
        vals, msks = probe_program(self.needle.data)
        return scan_kernel.batched_count_cols(
            None,
            np.asarray([vals], np.uint32),
            np.asarray([msks], np.uint32),
            np.asarray([dh.length], np.int32),
            s=dh.s,
            pw=dh.windows(),
        )[0]
