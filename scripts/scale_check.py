"""Large-corpus scale check (dev tool, GPU): ~134 MB x 502 needles.

Measures the sustained batched find sweep at a given segment geometry with
a bytes.find parity gate, so layout decisions at scale (docs/DESIGN.md
"Scale check") are reproducible.

Usage: python scripts/scale_check.py [seg_rows|default] [mb=134] [k=8]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import sliceslice_tpu as st


def main():
    seg_rows = None
    mb = 134
    k_sweeps = 8
    for a in sys.argv[1:]:
        if a.startswith("mb="):
            mb = int(a[3:])
        elif a.startswith("k="):
            k_sweeps = int(a[2:])
        elif a != "default":
            seg_rows = int(a)
    rng = np.random.default_rng(42)
    hay = rng.integers(97, 123, (mb * 2**20,), dtype=np.uint8).tobytes()
    needles = [
        hay[int(i) : int(i) + int(kk)]
        for i, kk in zip(
            rng.integers(0, len(hay) - 24, (502,)),
            rng.integers(8, 25, (502,)),
        )
    ]
    t0 = time.perf_counter()
    dh = st.preprocess(hay, kh=24, seg_rows=seg_rows, windows_only=True,
                       keep_host=False)
    bs = st.BatchedSearcher(needles)
    got = bs.find_all(dh)
    exp = np.array([hay.find(nd) for nd in needles])
    assert (got == exp).all(), "parity failed"
    print(f"preprocess+first sweep+parity: {time.perf_counter() - t0:.1f} s "
          f"(s={dh.s}, g={dh.g})")

    def sweep():
        for _ in range(k_sweeps - 1):
            bs.find_all_device(dh)
        bs.find_all_device(dh).block_until_ready()

    sweep()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        sweep()
        ts.append((time.perf_counter() - t0) / k_sweeps)
    per = min(ts)
    eff = len(needles) * len(hay) / per / 1e9
    print(f"s={dh.s} g={dh.g}: {per * 1e3:.1f} ms/sweep  "
          f"({eff:.0f} GB/s effective)")


if __name__ == "__main__":
    main()
