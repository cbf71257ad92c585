"""Competitor benchmark matrix — the criterion-bench analogue
(bench/benches/i386.rs, bench/benches/random.rs): the two reference sweeps
run against every implementation tier available here.

Rows:
* python ``bytes.find``       — stdlib baseline (``String::find`` analogue,
                                 itself Crochemore-Perrin like memmem)
* native SWAR (C++)           — this repo's CPU competitor
                                 (sse4-strstr-wrapper analogue)
* native Two-Way (C++)        — from-scratch Crochemore-Perrin
                                 (twoway/memmem competitor row analogue)
* sliceslice batched          — this framework on the GPU, sustained
* sliceslice pairwise         — the GPU short-sweep kernel

``collect_host()`` returns the same-host CPU rows structured so bench.py
can record them next to its own GPU rows (the reference publishes this
table, README.md:28-40).

Usage: python benchmarks/competitors.py  (markdown table to stdout; fails
without a GPU).
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def timed(fn, warmup=1, samples=3):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts), sorted(ts)[len(ts) // 2], max(ts)


def fmt(trip):
    return f"{trip[0]*1e3:.2f} / {trip[1]*1e3:.2f} / {trip[2]*1e3:.2f} ms"


def _corpus():
    hay = open(os.path.join(REPO, "data/i386.txt"), "rb").read()
    words = [
        w for w in open(os.path.join(REPO, "data/words.txt"), "rb")
        .read().split(b"\n") if w
    ]
    return hay, words


def collect_host(short: bool = True) -> dict:
    """Same-host CPU competitor rows, each a [low, median, high] ms triple:
    the long-haystack sweep for bytes.find / SWAR / Two-Way, plus the
    all-pairs short sweep for SWAR (single sample — it's a full matrix)."""
    from sliceslice_tpu.utils import native

    hay, words = _corpus()
    out = {
        "long_py_bytes_find_ms": [
            round(x * 1e3, 1)
            for x in timed(lambda: [hay.find(w) for w in words])
        ]
    }
    if native.available():
        out["long_native_swar_ms"] = [
            round(x * 1e3, 1)
            for x in timed(lambda: native.swar_find_batch(hay, words))
        ]
        out["long_native_twoway_ms"] = [
            round(x * 1e3, 1)
            for x in timed(lambda: native.twoway_find_batch(hay, words))
        ]
        if short:
            ws = sorted(words, key=len)
            t = timed(lambda: native.swar_pairwise(ws), warmup=0, samples=1)
            out["short_native_swar_allpairs_ms"] = round(t[0] * 1e3, 1)
    return out


def main():
    import jax

    import sliceslice_tpu as st
    from sliceslice_tpu.ops.pairwise import PairwiseSearcher
    from sliceslice_tpu.utils import native

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("competitors.py needs a GPU for its device rows")
    hay, words = _corpus()
    ws = sorted(words, key=len)

    rows = []

    # --- long haystack: 4585 words x 857 KB ------------------------------
    rows.append(("**long haystack** (ref sliceslice: 35.14/35.18/35.25 ms)", ""))
    rows.append(
        ("python bytes.find", fmt(timed(lambda: [hay.find(w) for w in words])))
    )
    if native.available():
        rows.append(
            ("native SWAR (C++)",
             fmt(timed(lambda: native.swar_find_batch(hay, words))))
        )
        rows.append(
            ("native Two-Way (C++)",
             fmt(timed(lambda: native.twoway_find_batch(hay, words))))
        )
    dh = st.preprocess(hay, kh=24)
    bs = st.BatchedSearcher(words)
    bs.find_all(dh)

    def sustained(k=8):
        for _ in range(k - 1):
            bs.find_all_device(dh)
        bs.find_all_device(dh).block_until_ready()

    t = timed(sustained)
    rows.append(
        ("sliceslice batched (sustained, per sweep)",
         fmt(tuple(x / 8 for x in t)))
    )
    rows.append(
        ("sliceslice batched (one-shot + readback)",
         fmt(timed(lambda: bs.find_all(dh))))
    )

    # --- short haystack: all ~10.5M word pairs ---------------------------
    rows.append(("**short haystack** (ref sliceslice: 79.28/79.42/79.60 ms)", ""))
    if native.available():
        rows.append(
            ("native SWAR (C++) all-pairs",
             fmt(timed(lambda: native.swar_pairwise(ws), warmup=0, samples=1)))
        )
    ps = PairwiseSearcher(ws)
    int(ps.count_matches_device())
    rows.append(
        ("sliceslice pairwise",
         fmt(timed(lambda: ps.count_matches_device().block_until_ready())))
    )

    width = max(len(r[0]) for r in rows)
    print(f"| {'implementation':<{width}} | time (low/median/high) |")
    print(f"|{'-' * (width + 2)}|------------------------|")
    for name, val in rows:
        print(f"| {name:<{width}} | {val} |")


if __name__ == "__main__":
    main()
