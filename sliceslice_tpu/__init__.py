"""sliceslice_tpu — a single-pattern substring-search framework for GPUs.

A from-scratch re-design of the capabilities of cloudflare/sliceslice-rs
(Wojciech Muła-style SIMD substring search) for an accelerator: column-major
byte tiles, packed uint32 window probes compared in Triton kernels and XLA,
shape-specialized searcher families, batched multi-needle sweeps, and a
mesh-sharded multi-device corpus scanner.  See SURVEY.md for the structural map of the reference this
build recreates.

Public API::

    from sliceslice_tpu import DynamicSearcher
    s = DynamicSearcher(b"ipsum")
    s.search_in(b"lorem ipsum dolor")     # -> True
    s.find(b"lorem ipsum dolor")          # -> 6

    from sliceslice_tpu import BatchedSearcher, preprocess
    hay = preprocess(open("corpus", "rb").read())
    BatchedSearcher([b"a", b"needle"]).find_all(hay)   # -> [offset|-1] * N
"""

from . import config
from .needle import MAX_NEEDLE_LEN, Needle, build_probe_table, probe_program
from .models import (
    BatchedSearcher,
    DynamicSearcher,
    MemchrSearcher,
    NaiveSearcher,
    PallasSearcher,
    XlaSearcher,
    naive_find,
    searcher_for_size,
)
from .ops import SENTINEL, DeviceHaystack, preprocess
from .ops.pairwise import PairwiseSearcher, pairwise_contains_all
from .searcher import EmptyNeedleSearcher, SearcherBase, overlapping_count
from .utils.streaming import StreamingScanner

__version__ = "0.6.0"

__all__ = [
    "config",
    "Needle",
    "MAX_NEEDLE_LEN",
    "probe_program",
    "build_probe_table",
    "BatchedSearcher",
    "DynamicSearcher",
    "MemchrSearcher",
    "NaiveSearcher",
    "PallasSearcher",
    "XlaSearcher",
    "naive_find",
    "searcher_for_size",
    "SENTINEL",
    "DeviceHaystack",
    "preprocess",
    "PairwiseSearcher",
    "pairwise_contains_all",
    "StreamingScanner",
    "SearcherBase",
    "overlapping_count",
    "EmptyNeedleSearcher",
]
