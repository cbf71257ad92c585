"""Random needle/haystack size matrix — the bench/benches/random.rs analogue.

Needle sizes {1, 5, 10, 20, 50, 100, 1000} (prefixes of data/needle) x
haystack sizes >= needle (prefixes of the 1000-byte data/haystack), single
``find`` per combination through ``DynamicSearcher`` — at these sizes its
host SWAR rung (``models/dynamic.HOST_HAY_BYTES``), so ``dynamic_us`` is a
host time; a device column is not measured yet.  Correctness is asserted
against the oracle for every cell.

``collect()`` returns the matrix as structured rows so ``bench.py`` can
record it (the reference records this matrix with criterion,
bench/benches/random.rs:12-118).

Usage: python benchmarks/random_matrix.py
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NEEDLE_SIZES = (1, 5, 10, 20, 50, 100, 1000)
HAY_SIZES = (1, 5, 10, 20, 50, 100, 1000)


def collect() -> list:
    """Run every cell; returns rows of
    {needle, haystack, match, py_us, swar_us, dynamic_us} (NaN-free: absent
    competitors omit their key)."""
    import sliceslice_tpu as st
    from sliceslice_tpu.utils import native

    needle_data = open(os.path.join(REPO, "data/needle"), "rb").read()
    hay_data = open(os.path.join(REPO, "data/haystack"), "rb").read()
    rows = []
    for ks in NEEDLE_SIZES:
        nd = needle_data[:ks]
        searcher = st.DynamicSearcher(nd)
        for hs in HAY_SIZES:
            if hs < ks:
                continue
            hay = hay_data[:hs]
            exp = st.naive_find(hay, nd)

            t0 = time.perf_counter()
            for _ in range(100):
                hay.find(nd)
            t_py = (time.perf_counter() - t0) / 100

            row = {
                "needle": ks, "haystack": hs,
                "py_us": round(t_py * 1e6, 2),
            }
            if native.available():
                native.swar_find(hay, nd)
                t0 = time.perf_counter()
                for _ in range(100):
                    native.swar_find(hay, nd)
                row["swar_us"] = round(
                    (time.perf_counter() - t0) / 100 * 1e6, 2
                )

            got = searcher.find(hay)
            assert got == exp, (ks, hs, got, exp)
            row["match"] = got is not None
            t0 = time.perf_counter()
            for _ in range(3):
                searcher.find(hay)
            row["dynamic_us"] = round((time.perf_counter() - t0) / 3 * 1e6, 0)
            rows.append(row)
    return rows


def main():
    rows = collect()
    print("| needle | haystack | match | python find | SWAR | DynamicSearcher |")
    print("|--------|----------|-------|-------------|------|-------------|")
    for r in rows:
        print(
            f"| {r['needle']} | {r['haystack']} | {r['match']} "
            f"| {r['py_us']:.2f} us | {r.get('swar_us', float('nan')):.2f} us "
            f"| {r['dynamic_us']:.0f} us |"
        )


if __name__ == "__main__":
    main()
