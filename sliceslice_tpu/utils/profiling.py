"""Criterion-analogue measurement harness (reference: criterion benches,
bench/benches/i386.rs): warmup, repeated samples, low/estimate/high from the
sample distribution, plus achieved bandwidth against the device's published
memory peak — the dual-metric idea (wall time + hardware-counter-like metric)
from the reference's perf-event benches (SURVEY.md §5.1)."""

from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Callable, Optional

#: Published device-memory bandwidth, bytes/s, keyed by JAX's
#: ``device_kind``.  Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5
#: part (80 GB HBM3 at 3.35 TB/s).
PEAK_MEMORY_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_memory_bandwidth(device_kind: str) -> float:
    """Published memory peak (bytes/s) of a device kind; an unknown kind is
    an error, never a default."""
    try:
        return PEAK_MEMORY_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(
            f"no published memory peak for device kind {device_kind!r}; "
            "add it to PEAK_MEMORY_BYTES_PER_S with its source"
        ) from None


def card_line() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them — a
    card may run below its maximum power limit, so every device number is
    reported beside this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


@dataclasses.dataclass
class Measurement:
    name: str
    samples_s: list
    bytes_processed: Optional[int] = None

    @property
    def low(self) -> float:
        return min(self.samples_s)

    @property
    def estimate(self) -> float:
        s = sorted(self.samples_s)
        return s[len(s) // 2]

    @property
    def high(self) -> float:
        return max(self.samples_s)

    def gbps(self, which: str = "estimate") -> Optional[float]:
        if self.bytes_processed is None:
            return None
        return self.bytes_processed / getattr(self, which) / 1e9

    def summary(self) -> str:
        ms = [f"{x * 1e3:.3f}" for x in (self.low, self.estimate, self.high)]
        line = f"{self.name}: [{ms[0]} {ms[1]} {ms[2]}] ms"
        if self.bytes_processed is not None:
            line += f"  ({self.gbps():.1f} GB/s effective)"
        return line


def measure(
    fn: Callable[[], object],
    name: str = "bench",
    warmup: int = 1,
    samples: int = 5,
    bytes_processed: Optional[int] = None,
) -> Measurement:
    """Run fn with warmup then timed samples (fn must block on completion,
    e.g. end in np.asarray / block_until_ready)."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return Measurement(name, out, bytes_processed)


def trace(fn, logdir: str):
    """Capture a jax.profiler trace of one invocation (SURVEY.md §5.1: the
    device-side observability story — per-kernel device time from the
    trace instead of Linux perf events)."""
    import jax

    with jax.profiler.trace(logdir):
        out = fn()
        jax.block_until_ready(out)
    return logdir
