"""Scaling harness: bytes/s vs device count (BASELINE target: >= 90% linear
scaling of corpus-scan throughput from 1 device to N).

On a real pod slice, run with the full mesh; on a single host the same
harness demonstrates the scaling *shape* on an
``xla_force_host_platform_device_count`` virtual CPU mesh (the reference
analogously executes its wasm backend under wasmtime rather than real
hardware, check.yml).  Every measurement re-verifies exactness against the
single-device result.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import jax
import numpy as np

from ..needle import build_probe_table
from ..ops.layout import DeviceHaystack
from .mesh import make_mesh
from .shard_scan import sharded_find_cols


def granularity_efficiency(g: int, n: int) -> float:
    """Upper bound on scaling efficiency from whole-segment sharding alone:
    a shard receives ``ceil(g/n)`` of ``g`` segments, so the slowest shard
    determines the step time.  >= 90% whenever g >= 9n (docs/SCALING.md) —
    shard corpora so each chip holds >= 9 segments, or raise ``g`` via
    ``preprocess(seg_rows=...)``."""
    if g <= 0 or n <= 0:
        raise ValueError("g and n must be positive")
    return g / (n * -(-g // n))


def predicted_efficiency(
    g: int,
    n: int,
    bytes_per_shard: int,
    scan_gbps: float = 666.0,
    allreduce_bytes: int = 2 * 4 * 4096,
    link_gbps: float = 50.0,
) -> float:
    """Cost-model efficiency bound: granularity skew x communication term
    (tiny collectives per query batch vs B/n bytes of scan per chip).
    Defaults: an assumed never-match fullscan rate (the conservative,
    data-independent regime), a mid-range interconnect bandwidth, and the
    find
    reduction's real traffic — two int32 ``pmin``s per needle (the
    lexicographic (shard, local-offset) combine; counts are a two-limb
    ``psum``, same 2x4xN bytes)."""
    scan_s = bytes_per_shard / (scan_gbps * 1e9)
    comm_s = allreduce_bytes / (link_gbps * 1e9)
    return granularity_efficiency(g, n) * scan_s / (scan_s + comm_s)


def measure_scaling(
    dh: DeviceHaystack,
    needles: Sequence[bytes],
    device_counts: Optional[Sequence[int]] = None,
    samples: int = 3,
) -> List[dict]:
    """Per device count: median sweep seconds, bytes/s, efficiency vs linear."""
    devices = jax.devices()
    if device_counts is None:
        device_counts = [
            n for n in (1, 2, 4, 8, 16, 32, 64) if n <= len(devices)
        ]
    values, masks, lengths = build_probe_table(needles)
    ends = np.maximum(
        np.int64(dh.length) - lengths.astype(np.int64) + 1, 0
    )
    total_bytes = dh.length * len(needles)

    results = []
    reference_out = None
    base_rate = None
    base_n = None
    for n in device_counts:
        mesh = make_mesh((n, 1), devices=devices[:n])
        out = np.asarray(sharded_find_cols(dh, values, masks, ends, mesh))
        if reference_out is None:
            reference_out = out
        else:
            assert (out == reference_out).all(), f"divergence at n={n}"
        ts = []
        for _ in range(samples):
            t0 = time.perf_counter()
            r = sharded_find_cols(dh, values, masks, ends, mesh)
            if not isinstance(r, np.ndarray):
                r.block_until_ready()  # >2 GiB path returns host int64
            ts.append(time.perf_counter() - t0)
        sec = sorted(ts)[len(ts) // 2]
        rate = total_bytes / sec
        if base_rate is None:
            base_rate, base_n = rate, n
        results.append(
            {
                "devices": n,
                "seconds": sec,
                "bytes_per_s": rate,
                # Efficiency vs linear FROM THE FIRST MEASURED POINT (a pod
                # may not be able to run n=1).
                "efficiency": rate / (base_rate * n / base_n),
            }
        )
    return results


def format_report(results: List[dict]) -> str:
    lines = ["| devices | sweep s | GB/s | efficiency vs linear |",
             "|---------|---------|------|----------------------|"]
    for r in results:
        lines.append(
            f"| {r['devices']} | {r['seconds']:.4f} | "
            f"{r['bytes_per_s'] / 1e9:.2f} | {r['efficiency'] * 100:.1f}% |"
        )
    return "\n".join(lines)
