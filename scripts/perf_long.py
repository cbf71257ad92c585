"""Perf iteration harness for the long-sweep kernel (dev tool, GPU).

Times four found-offset regimes of the batched find kernel so a kernel
change can be judged per regime:

* real      — the actual 4,585 dictionary words (the headline workload);
* floor     — synthetic needles that all match in segment 0 (the
              one-segment cost of every block);
* fullscan  — synthetic needles that never match (every block walks all
              segments: pure compare-throughput regime);
* sparse    — one never-found needle per kernel block among floor needles
              (every block walks every segment for one needle).

Usage: python scripts/perf_long.py [K]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sliceslice_tpu as st
from sliceslice_tpu.utils.profiling import measure


def run(name, words, dh, total_bytes, k):
    bs = st.BatchedSearcher(words)

    def sweep():
        for _ in range(k - 1):
            bs.find_all_device(dh)
        bs.find_all_device(dh).block_until_ready()

    m = measure(sweep, name=f"{name} x{k}", warmup=1, samples=5,
                bytes_processed=total_bytes * k)
    per = 1e3 * m.estimate / k
    print(f"{name:9s}: {per:7.3f} ms/sweep   ({m.gbps('estimate'):7.1f} GB/s eff)")
    return per


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    hay = open("data/i386.txt", "rb").read()
    words = [w for w in open("data/words.txt", "rb").read().split(b"\n") if w]
    dh = st.preprocess(hay, kh=24)
    total = len(words) * len(hay)

    rng = np.random.default_rng(0)
    # floor: 8-byte needles copied from random offsets in the first 32 KiB
    # (first segment), so every needle is found in segment 0.
    floor = []
    seen = set()
    while len(floor) < len(words):
        off = int(rng.integers(0, 32 * 1024 - 8))
        w = hay[off:off + 8]
        if w not in seen:
            seen.add(w)
            floor.append(w)
    # fullscan: 8 random bytes with a 0xFF (never in ASCII text).
    fullscan = [bytes([0xFF]) + bytes(rng.integers(1, 255, 7).tolist())
                for _ in range(len(words))]

    # sparse: one never-found needle per kernel block.
    from sliceslice_tpu.ops.scan_kernel import NEEDLE_BLOCK

    sparse = list(floor)
    for i in range(0, len(sparse), NEEDLE_BLOCK):
        sparse[i] = fullscan[i]

    run("real", words, dh, total, k)
    run("floor", floor, dh, total, k)
    run("fullscan", fullscan, dh, total, k)
    run("sparse", sparse, dh, total, k)


if __name__ == "__main__":
    main()
