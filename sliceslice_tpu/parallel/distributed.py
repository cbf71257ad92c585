"""Multi-host process setup — the jax.distributed wrapper layer
(BASELINE.json: multi-host corpus sharding with match flags reduced via
collectives).

The scan itself needs nothing beyond shard_scan.py: `jax.distributed`
initialization makes every host's chips part of one global mesh, and
`make_global_corpus` assembles a globally-sharded corpus from per-host
segment ranges without any host ever materializing the full corpus.
Stateless like the reference — failure recovery is re-running the shard at
the CLI layer (SURVEY.md §5.3), nothing in-library.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.layout import LANES, MIN_KH, _build_cols, round_up
from .mesh import DATA_AXIS, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX (no-op when single-process).

    Pass ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` explicitly: nothing here detects a cluster.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(needle_axis: int = 1) -> Mesh:
    """Mesh over every chip of every host; data axis spans hosts (segment
    shards ride DCN only at the final one-int32-per-needle pmin)."""
    n = jax.device_count()
    if n % needle_axis:
        raise ValueError(f"{n} devices not divisible by needle axis {needle_axis}")
    return make_mesh((n // needle_axis, needle_axis))


def make_global_corpus(
    local_segments: np.ndarray, mesh: Mesh
) -> jax.Array:
    """Assemble a globally segment-sharded corpus from this host's local
    segment block ``(g_local, S+KH, 128)``.  Host i contributes segments
    ``[i*g_local, (i+1)*g_local)`` of the global corpus; no host touches the
    rest."""
    global_g = local_segments.shape[0] * jax.process_count()
    shape = (global_g,) + local_segments.shape[1:]
    sharding = NamedSharding(mesh, P(DATA_AXIS, None, None))
    return jax.make_array_from_process_local_data(
        sharding, local_segments, shape
    )


def local_segment_block(
    local_bytes: bytes, peek: bytes, s: int, kh: int,
    g_local: Optional[int] = None,
) -> np.ndarray:
    """Build this host's cols block ``(g_local, s+kh, 128)`` from its
    contiguous byte range of the global corpus.

    ``local_bytes``: the host's range, zero-padded by the CALLER to a whole
    number of segments only on the final host (every other host's range is
    exactly ``g_local * s * 128`` bytes by construction).  ``peek``: the
    ``kh`` bytes that FOLLOW the range in the global stream (shorter/empty
    at corpus end) — the halo rows of the last local segment read them, the
    same cross-boundary context the single-host layout takes from the next
    segment (ops/layout.py).  kh must be pre-rounded (multiple of 32).
    ``g_local`` forces the block's segment count (every process must
    contribute the same count; the final host's tail becomes all-pad
    segments whose positions lie beyond every needle's end)."""
    kh = round_up(max(kh, MIN_KH), 32)
    seg = s * LANES
    if g_local is None:
        g_local = -(-len(local_bytes) // seg)
    elif len(local_bytes) > g_local * seg:
        raise ValueError(
            f"local range of {len(local_bytes)} bytes exceeds "
            f"g_local*seg = {g_local * seg}"
        )
    total = g_local * seg + kh
    padded = np.zeros((total,), dtype=np.uint8)
    arr = np.frombuffer(local_bytes, dtype=np.uint8)
    padded[: len(arr)] = arr
    pk = np.frombuffer(peek[:kh], dtype=np.uint8)
    padded[g_local * seg : g_local * seg + len(pk)] = pk
    return np.asarray(_build_cols(padded, g_local, s, kh))


@dataclasses.dataclass
class GlobalCorpus:
    """A globally segment-sharded corpus — the multi-host counterpart of
    ``DeviceHaystack`` (duck-typed for the shard_scan entry points: exposes
    ``tiled``/``s``/``g``/``length``/``windows()``/``require_cols()``).
    Built by :func:`assemble_global_corpus`; ``length`` is the TRUE global
    byte length (int, unbounded — offsets past 2 GiB take shard_scan's
    int64 path automatically).

    ``local_bytes``/``local_peek``/``local_base`` (kept by default — they
    are references the caller already holds, not copies) let huge-needle
    searches verify candidates against this process's byte range without
    any host ever assembling the corpus: a candidate is verified by the
    process whose range contains its first byte, reading into the peek for
    range-straddling matches (the peek must then cover the needle's tail —
    ``len(needle) - 1`` bytes — or reach the corpus end)."""

    length: int
    s: int
    g: int
    kh: int
    cols: jax.Array  # uint8 (g, s+kh, 128), sharded over the data axis
    pw: Optional[jax.Array] = None
    #: this process's contiguous byte range (verify source for huge needles)
    local_bytes: Optional[bytes] = None
    #: bytes following the local range in the global stream
    local_peek: bytes = b""
    #: global offset of ``local_bytes[0]``
    local_base: int = 0

    @property
    def tiled(self) -> bool:
        return True

    @property
    def seg_bytes(self) -> int:
        return self.s * LANES

    def require_cols(self) -> jax.Array:
        return self.cols

    def windows(self) -> jax.Array:
        """Packed uint32 windows, derived shard-locally (the pack is
        per-segment, so sharding propagates with no communication)."""
        if self.pw is None:
            from ..ops.layout import _pack_all

            self.pw = _pack_all(self.cols)
        return self.pw


def assemble_global_corpus(
    local_bytes: bytes,
    peek: bytes,
    global_length: int,
    s: int,
    kh: int,
    mesh: Mesh,
    g_local: Optional[int] = None,
    keep_local: bool = True,
) -> GlobalCorpus:
    """Per-host corpus bring-up: each process calls this with ITS contiguous
    byte range (process_id order), the following peek bytes (at least ``kh``
    used for halo rows; longer peeks enable huge-needle verify across the
    range boundary), and the true global length; no host ever materializes
    the full corpus.  ``g_local`` (same on every process) must make the
    global segment count divisible by the mesh's data axis; default = this
    range's segment count.  ``keep_local`` retains the (caller-held) byte
    references on the corpus for huge-needle filter+verify."""
    kh = round_up(max(kh, MIN_KH), 32)
    block = local_segment_block(local_bytes, peek[:kh], s, kh, g_local=g_local)
    cols = make_global_corpus(block, mesh)
    g = block.shape[0] * jax.process_count()
    base = jax.process_index() * block.shape[0] * s * LANES
    return GlobalCorpus(
        length=global_length, s=s, g=g, kh=kh, cols=cols,
        local_bytes=local_bytes if keep_local else None,
        local_peek=peek if keep_local else b"",
        local_base=base,
    )


def allgather_i64(arr: np.ndarray) -> np.ndarray:
    """``process_allgather`` for int64 HOST arrays, exact past 2^31.

    jax's default 32-bit mode silently downcasts int64 inputs to int32 on
    the way through the collective (offsets past 2 GiB would truncate, and
    int64 sentinels wrap), so the value rides as two int32 limbs and
    recombines on host.  Returns ``(process_count, *arr.shape)``;
    single-process returns ``arr[None]`` without any collective."""
    a = np.asarray(arr, np.int64)
    if jax.process_count() == 1:
        return a[None]
    from jax.experimental import multihost_utils

    hi = (a >> 32).astype(np.int32)
    lo = a.astype(np.uint32).astype(np.int32)  # low 32 bits, bit-exact
    g = np.asarray(
        multihost_utils.process_allgather(np.stack([hi, lo]))
    ).reshape((jax.process_count(), 2) + a.shape)
    return (g[:, 0].astype(np.int64) << 32) | (
        g[:, 1].astype(np.int64) & 0xFFFFFFFF
    )


def gather_positions(parts: list, axis_name: Optional[str] = None) -> list:
    """Gather per-process position lists (``sharded_positions`` /
    ``ShardedBatchedSearcher.positions_all`` output: one int64 array per
    needle, each process holding only offsets decoded from ITS addressable
    shards) into the GLOBAL sorted list on every process.

    Single-process: returns ``parts`` unchanged.  Multi-process: lengths are
    allgathered first, arrays zero-padded to the global max and allgathered
    (one host collective each), then sliced back and merged.  Processes own
    disjoint ascending corpus ranges, so the merge is a concatenation in
    process order plus a defensive sort."""
    if jax.process_count() == 1:
        return list(parts)
    n = len(parts)
    counts = np.asarray([int(p.size) for p in parts], np.int64)
    all_counts = allgather_i64(counts)  # (P, n)
    m = int(all_counts.max()) if all_counts.size else 0
    padded = np.zeros((n, max(m, 1)), np.int64)
    for i, p in enumerate(parts):
        padded[i, : p.size] = np.asarray(p, np.int64)
    allp = allgather_i64(padded)  # (P, n, m)
    out = []
    for i in range(n):
        segs = [
            allp[q, i, : all_counts[q, i]] for q in range(allp.shape[0])
        ]
        arr = (
            np.concatenate(segs) if segs else np.empty((0,), np.int64)
        )
        arr.sort(kind="stable")
        out.append(arr)
    return out
