"""Utility-layer tests: measurement harness, mmap ingest, trace capture."""

import os

import numpy as np

from sliceslice_tpu.utils import Measurement, load_haystack, map_file, measure
from sliceslice_tpu.utils.profiling import trace


def test_measure_and_summary():
    calls = []
    m = measure(lambda: calls.append(1), name="x", warmup=2, samples=5,
                bytes_processed=1000)
    assert len(calls) == 7
    assert m.low <= m.estimate <= m.high
    assert m.gbps() is not None
    assert "GB/s" in m.summary()
    assert Measurement("y", [1.0]).gbps() is None


def test_map_file_and_load(tmp_path):
    p = tmp_path / "c.bin"
    p.write_bytes(b"hello corpus " * 1000)
    arr = map_file(str(p))
    assert arr.dtype == np.uint8 and bytes(arr[:5]) == b"hello"
    dh = load_haystack(str(p))
    assert dh.length == 13_000
    empty = tmp_path / "e.bin"
    empty.write_bytes(b"")
    assert map_file(str(empty)).size == 0


def test_trace_capture(tmp_path):
    import jax.numpy as jnp

    logdir = trace(lambda: jnp.arange(8) * 2, logdir=str(tmp_path / "tr"))
    found = []
    for root, _dirs, files in os.walk(logdir):
        found += files
    assert found, "trace produced no files"


def test_streaming_int64_offsets_past_2gib():
    """Offsets beyond the int32 range are exact through the PUBLIC API:
    device math is window-local int32, the global base folds in int64 on
    host.  ``start_offset`` declares the stream's global origin, so window
    bases cross 2^32 without materializing gigabytes (the on-device 4.5 GiB
    materialized check is scripts/bigscan_check.py)."""
    from sliceslice_tpu.utils.streaming import StreamingScanner

    win = 2**16
    start = 2**32 - win + 64  # the second window's base is past 2^32
    data = bytes(win) + b"xxxxxneedle-in-window-two" + bytes(503)
    sc = StreamingScanner([b"needle", b"absent-needle"], window_bytes=win)
    got = sc.find_in_chunks(
        iter([data[:40_000], data[40_000:]]),
        early_stop=False,
        start_offset=start,
    )
    assert got[0] == start + win + 5 and got[0] > 2**32
    assert got[1] == -1
    cnt = sc.count_in_chunks(iter([data]))
    assert list(cnt) == [1, 0]
    pos = sc.positions_in_chunks(iter([data]), start_offset=start)
    assert list(pos[0]) == [start + win + 5]
    assert pos[1].size == 0
