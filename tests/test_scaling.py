"""Scaling harness on the virtual 8-device mesh: exactness across device
counts plus report formatting (throughput numbers are meaningless on
interpreted CPU; exactness and plumbing are what's testable here)."""

import numpy as np

from sliceslice_tpu.ops.layout import preprocess
from sliceslice_tpu.parallel import format_report, measure_scaling

import jax
import pytest

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="needs an 8-device mesh (the suite's virtual CPU devices)",
)



def test_granularity_efficiency_model():
    """The cost model's skew term: exact at divisibility, >= 90% when a
    shard holds >= 9 segments, monotone non-increasing in n at fixed g,
    and always in (0, 1]."""
    from sliceslice_tpu.parallel.scaling import (
        granularity_efficiency,
        predicted_efficiency,
    )

    assert granularity_efficiency(64, 8) == 1.0
    assert granularity_efficiency(9, 1) == 1.0
    # g >= 9n bound from docs/SCALING.md.
    for n in (2, 3, 8, 17, 64):
        assert granularity_efficiency(9 * n, n) >= 0.9
        assert granularity_efficiency(9 * n + 1, n) >= 0.9
    # Worst case: one extra segment forces a whole extra step on one shard.
    assert granularity_efficiency(9, 8) == 9 / 16
    for n in range(1, 33):
        assert 0 < granularity_efficiency(100, n) <= 1
    # The full prediction degrades gracefully as shards shrink, and the
    # communication term only matters for tiny shards.
    big = predicted_efficiency(g=256, n=8, bytes_per_shard=32 * 2**20)
    tiny = predicted_efficiency(g=256, n=8, bytes_per_shard=64 * 2**10)
    # Comm term models the real traffic (two 4*N-byte pmins per batch).
    assert big > 0.98
    assert tiny < big
    with pytest.raises(ValueError):
        granularity_efficiency(0, 4)


def test_measure_scaling_exactness(rng):
    corpus = bytes(rng.integers(97, 103, (700_000,), dtype=np.uint8))
    dh = preprocess(corpus, kh=16)
    needles = [corpus[i : i + k] for i, k in [(5, 4), (650_000, 8), (0, 2)]]
    needles.append(b"QZX")
    res = measure_scaling(dh, needles, device_counts=[1, 2, 8], samples=1)
    assert [r["devices"] for r in res] == [1, 2, 8]
    assert res[0]["efficiency"] == 1.0
    report = format_report(res)
    assert "devices" in report and "| 8 |" in report
