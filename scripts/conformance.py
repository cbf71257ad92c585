"""Full i386 conformance sweep on the GPU.

The reference's CI RUNS the complete conformance corpus on every push
(tests/i386.rs:46-70): every word of the 4,585-word dictionary searched in
every same-or-longer word (~10.5M ordered pairs), and every word searched
in the 857,425-byte i386 manual.  This script runs both sweeps in FULL on
the device and compares them against the host ``bytes.find`` oracle at
first-match-OFFSET granularity (a strict superset of the reference's bool
assertions — BASELINE.json demands offsets).  It prints one JSON object:

    {"short_pairs": ..., "short_mismatches": 0, "short_total_checked": ...,
     "long_words": 4585, "long_mismatches": 0, "device": {...}}

and fails without a GPU or on any mismatch.  ``bench.py`` runs the same
sweeps in-process.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_conformance() -> dict:
    """Execute both sweeps; returns the result dict."""
    import jax

    import sliceslice_tpu as st
    from sliceslice_tpu.ops.pairwise import PairwiseSearcher

    hay = open(os.path.join(REPO, "data/i386.txt"), "rb").read()
    words = [
        w for w in open(os.path.join(REPO, "data/words.txt"), "rb")
        .read().split(b"\n") if w
    ]

    # Long sweep: all words x the manual, offsets.
    dh = st.preprocess(hay, kh=24)
    got_long = st.BatchedSearcher(words).find_all(dh)
    exp_long = np.asarray([hay.find(w) for w in words])
    long_mm = int((got_long != exp_long).sum())

    # Short sweep: the full ordered word x word matrix, offsets.  The
    # reference sweep is the ~10.5M same-or-longer pairs; the matrix is all
    # N^2 ordered pairs (shorter haystacks must report absent), a superset.
    ws = sorted(words, key=len)
    ps = PairwiseSearcher(ws)
    got_short = np.asarray(ps.first_matrix())  # int32[N, N] -1 absent
    lens = np.asarray([len(w) for w in ws])
    short_pairs = int((lens[None, :] >= lens[:, None]).sum())
    exp_short = np.empty_like(got_short)
    for i, nd in enumerate(ws):
        exp_short[i] = [h.find(nd) for h in ws]
    short_mm = int((got_short != exp_short).sum())

    return {
        "device": {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "count": len(jax.devices()),
        },
        "long_words": len(words),
        "long_mismatches": long_mm,
        "short_words": len(ws),
        "short_pairs": short_pairs,
        "short_total_checked": int(exp_short.size),
        "short_mismatches": short_mm,
    }


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("conformance.py needs a GPU")
    result = run_conformance()
    print(json.dumps(result))
    if result["long_mismatches"] or result["short_mismatches"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
