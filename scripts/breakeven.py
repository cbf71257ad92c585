"""Measure the optimize_for break-even point (dev tool, GPU).

``BatchedSearcher.optimize_for`` reorders group rows by first-match offsets;
since r4 the scatter order and probe tables are kernel OPERANDS, so the
reschedule itself is a host permute + async device uploads — zero
recompiles, zero device readbacks.  Two protocols on the i386 word workload
(4,585 needles x 857 KB):

  cold      — optimize_for(dh): pays ONE measuring sweep (device scan,
              no readback);
  piggyback — optimize_for(dh, firsts): a serving loop already holds the
              last sweep's results, so the reschedule is pure overhead.

For each: t_base (ms/sweep before), c_opt (one-shot cost), t_opt (after),
N* = c_opt / (t_base - t_opt) sweeps to break even.

Usage: python scripts/breakeven.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import sliceslice_tpu as st


def sustained(fn, k=32, rounds=4):
    ts = []
    fn()  # warm
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(k - 1):
            fn()
        fn().block_until_ready()
        ts.append((time.perf_counter() - t0) / k)
    return min(ts)


def protocol(name, words, hay, piggyback: bool):
    bs = st.BatchedSearcher(words)
    dh = st.preprocess(hay, kh=bs.max_t * 4)
    run = lambda: bs.find_all_device(dh)
    baseline = np.asarray(run())
    t_base = sustained(run)

    if piggyback:
        firsts = bs.find_all(dh)  # the serving loop's own last results
        t0 = time.perf_counter()
        bs.optimize_for(dh, firsts)
        c_opt = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        bs.optimize_for(dh)
        c_opt = time.perf_counter() - t0

    opt = np.asarray(run())
    assert (opt == baseline).all(), "optimize_for changed results"
    t_opt = sustained(run)
    gain = t_base - t_opt
    n_star = c_opt / gain if gain > 0 else float("inf")
    print(f"[{name}]")
    print(f"  t_base : {t_base * 1e3:7.2f} ms/sweep")
    print(f"  c_opt  : {c_opt * 1e3:7.2f} ms one-shot")
    print(f"  t_opt  : {t_opt * 1e3:7.2f} ms/sweep")
    print(f"  gain   : {gain * 1e3:7.2f} ms/sweep ({t_base / t_opt:.2f}x)")
    print(f"  N*     : {n_star:7.1f} sweeps to break even")
    return n_star


def main():
    words = open("data/words.txt", "rb").read().splitlines()
    hay = open("data/i386.txt", "rb").read()
    # First cold run pays the one-time XLA compile of the device
    # scheduler program (r5: the cold path is sweep -> device argsort ->
    # device permute, zero readbacks); the second shows the steady cost a
    # serving process actually pays.
    protocol("cold, first (incl. scheduler compile)", words, hay, False)
    protocol("cold: optimize_for(dh), one measuring sweep", words, hay, False)
    protocol("piggyback: optimize_for(dh, firsts)", words, hay, True)


if __name__ == "__main__":
    main()
