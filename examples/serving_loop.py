"""Example: sustained query serving — the production throughput pattern.

Every device->host readback costs a round trip that a sweep's device time
need not wait for, so a serving loop keeps results on device, pipelines
query batches with async dispatch, and syncs once per drain interval:

    python examples/serving_loop.py
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

import sliceslice_tpu as st


def main():
    hay = open("data/i386.txt", "rb").read()
    dh = st.preprocess(hay)  # corpus resident on device, once
    words = [w for w in open("data/words.txt", "rb").read().split(b"\n") if w]

    # A "query stream": batches of needles arriving over time.
    rng = np.random.default_rng(0)
    batches = [
        [words[int(i)] for i in rng.integers(0, len(words), 512)]
        for _ in range(12)
    ]

    # Searcher construction is the per-batch host cost (~1 ms/512 needles).
    searchers = [st.BatchedSearcher(b) for b in batches]
    # Warm pass: pads bucket group sizes, so the handful of distinct kernel
    # shapes compile once here and every later batch reuses them.
    for s in searchers:
        s.find_all_device(dh)

    t0 = time.time()
    pending = [s.find_all_device(dh) for s in searchers]  # async dispatch
    results = [np.asarray(r) for r in pending]  # one drain
    dt = time.time() - t0

    n_queries = sum(len(b) for b in batches)
    found = sum(int((r < st.SENTINEL).sum()) for r in results)
    print(
        f"{n_queries} queries over {len(hay):,} bytes in {dt*1e3:.1f} ms "
        f"({n_queries/dt:,.0f} queries/s; {found} matched)"
    )


if __name__ == "__main__":
    main()
