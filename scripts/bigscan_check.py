"""Scale check: stream a synthetic >4 GiB corpus and assert exact int64
first-match offsets (the 2 GiB int32 ceiling is gone end to end).

The corpus is generated procedurally in chunks (never materialized whole,
sliceslice_tpu.utils.corpus_gen): lowercase-random filler with distinctive
uppercase needles planted at known offsets, including past 2**31 and
2**32.  An absent needle proves the no-match path, and a needle planted
twice proves first-occurrence semantics across distant windows.

Usage:  python scripts/bigscan_check.py [total_gib]    (default 4.5)
"""

import sys
import time

sys.path.insert(0, ".")

from sliceslice_tpu.utils.corpus_gen import (
    boundary_plants,
    first_offsets,
    planted_chunks,
)
from sliceslice_tpu.utils.streaming import StreamingScanner


def main():
    total = int(float(sys.argv[1]) * 2**30) if len(sys.argv) > 1 else int(4.5 * 2**30)
    plants = boundary_plants(total)
    expected = first_offsets(plants)
    needles = sorted(expected) + [b"ABSENT-NEEDLE-Z!"]
    exp = [expected.get(nd, -1) for nd in needles]

    sc = StreamingScanner(needles, window_bytes=128 * 1024 * 1024)
    t0 = time.perf_counter()
    got = sc.find_in_chunks(planted_chunks(total, plants), early_stop=False)
    dt = time.perf_counter() - t0

    ok = list(got) == exp
    gbs = total / dt / 1e9
    print(f"total {total / 2**30:.2f} GiB in {dt:.1f} s  ({gbs:.2f} GB/s "
          "end-to-end incl. host generation + upload)")
    for nd, g, e in zip(needles, got, exp):
        mark = "ok" if g == e else f"MISMATCH (expected {e})"
        print(f"  {nd.decode():18s} -> {g:>13d}  {mark}")
    if not ok:
        sys.exit(1)
    print("bigscan: exact int64 parity past 4 GiB")


if __name__ == "__main__":
    main()
