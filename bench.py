"""Headline benchmark: the i386 long-haystack sweep (BASELINE.md), on a GPU.

Every one of the 4,585 dictionary words searched over the 857,425-byte Intel
80386 manual — the reference's long-haystack criterion bench
(bench/benches/i386.rs:157-284, README table row "sliceslice ... long
haystack": 35.181 ms on an i7-6700).  Metric: effective scan throughput =
needles x haystack_bytes / wall seconds, GB/s per GPU.  vs_baseline is the
ratio against the reference's implied effective throughput
(4,585 x 857,425 B / 35.181 ms = 111.7 GB/s).

The streaming phase runs FIRST, in child processes one at a time, before
this process initializes JAX: a JAX process reserves most of the card's
memory, so only one may hold the card at a time.  Everything else runs
in-process afterwards.  The script fails without a GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"};
``--detail PATH`` also writes every row measured.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy as np

#: Reference long-haystack sweep: 35.181 ms criterion estimate (README.md:38).
REFERENCE_SWEEP_S = 0.035181


def group_times(bs, dh, K: int = 32) -> dict:
    """Per-group sustained device time (ms) for one i386 sweep, measured
    program by program — the second measurement axis (the reference
    publishes retired-instruction counts next to wall time,
    bench/benches/i386.rs:297-305)."""
    from sliceslice_tpu.ops import scan_kernel
    from sliceslice_tpu.utils.profiling import measure

    pw = dh.windows()
    rows = {}

    def sustained(fn):
        def run():
            for _ in range(K - 1):
                fn()
            fn().block_until_ready()

        return round(1e3 * measure(run, warmup=1, samples=5).low / K, 4)

    for g in bs.groups:
        e = g.ends_dev(dh.length)
        for op, fn in (("find", scan_kernel.batched_find_cols),
                       ("count", scan_kernel.batched_count_cols)):
            rows[f"{op}[t={g.t},n={g.n}]"] = sustained(
                lambda fn=fn, g=g, e=e: fn(
                    None, g.values_dev, g.masks_dev, e, s=dh.s, pw=pw
                )
            )
    rows["fused_find_sweep"] = sustained(lambda: bs.find_all_device(dh))
    rows["fused_count_sweep"] = sustained(
        lambda: bs.count_all_device(dh, _allow_huge=True)
    )
    return rows


def streaming_phase(long_bytes: int = 1 << 30) -> dict:
    """Run scripts/stream_bench.py while THIS process has not yet touched
    jax: its child processes hold the card one at a time.  Must be called
    before any jax import here."""
    assert "jax" not in sys.modules, (
        "streaming phase must run before the parent imports jax"
    )
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts/stream_bench.py"),
         str(long_bytes)],
        capture_output=True, text=True, timeout=6600, cwd=REPO,
    )
    if proc.returncode:
        raise SystemExit(f"streaming phase failed: {proc.stderr[-1200:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    detail_path = None
    if "--detail" in sys.argv:
        detail_path = sys.argv[sys.argv.index("--detail") + 1]
    streaming = streaming_phase()

    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found "
                         f"{jax.devices()[0].platform!r}")
    import conformance
    import sliceslice_tpu as st
    from sliceslice_tpu.ops.pairwise import PairwiseSearcher
    from sliceslice_tpu.utils.profiling import card_line, measure

    hay = open(os.path.join(REPO, "data/i386.txt"), "rb").read()
    words = [
        w for w in open(os.path.join(REPO, "data/words.txt"), "rb")
        .read().split(b"\n") if w
    ]
    dh = st.preprocess(hay, kh=24)
    bs = st.BatchedSearcher(words)

    # Correctness gate first: the number is meaningless if parity fails.
    exp = np.array([hay.find(w) for w in words])
    if not (bs.find_all(dh) == exp).all():
        raise SystemExit("FAILED_CONFORMANCE")
    # Adaptive block scheduling (models/batched.py optimize_for), then
    # exactness re-gated.
    bs.optimize_for(dh)
    if not (bs.find_all(dh) == exp).all():
        raise SystemExit("FAILED_CONFORMANCE_AFTER_OPTIMIZE")

    total_bytes = len(words) * len(hay)
    # Sustained throughput: K async sweeps, one device sync — the criterion
    # warm-loop equivalent for an accelerator (results stay device-resident
    # between sweeps).
    K = 32

    def sweep_batch():
        for _ in range(K - 1):
            bs.find_all_device(dh)
        bs.find_all_device(dh).block_until_ready()

    m = measure(sweep_batch, name=f"i386-long-sweep x{K}", warmup=1,
                samples=5, bytes_processed=total_bytes * K)
    print(m.summary(), file=sys.stderr)
    one = measure(lambda: bs.find_all(dh), name="one-shot (incl. readback)",
                  warmup=1, samples=5, bytes_processed=total_bytes)
    print(one.summary(), file=sys.stderr)

    ps = PairwiseSearcher(sorted(words, key=len))

    def short_batch():
        for _ in range(K - 1):
            ps.count_matches_device()
        ps.count_matches_device().block_until_ready()

    short = measure(short_batch, name=f"short all-pairs sweep x{K}",
                    warmup=1, samples=5)
    print(short.summary(), file=sys.stderr)

    def triple(meas, scale=1.0):
        return [1e3 * x * scale for x in (meas.low, meas.estimate, meas.high)]

    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    import competitors
    import random_matrix

    conf = conformance.run_conformance()
    if conf["long_mismatches"] or conf["short_mismatches"]:
        raise SystemExit(f"FAILED_FULL_CONFORMANCE: {conf}")
    device = {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
        "card": card_line(),
    }
    detail = {
        "device": device,
        "sustained_ms_per_sweep_triple": triple(m, 1 / K),
        "oneshot_ms_triple": triple(one),
        "short_sweep_ms_triple": triple(short, 1 / K),
        "groups": group_times(bs, dh, K),
        "random_matrix": random_matrix.collect(),
        "competitors": competitors.collect_host(),
        "streaming": streaming,
        "conformance": conf,
    }
    if detail_path:
        with open(detail_path, "w") as f:
            json.dump(detail, f, indent=1)
    value = m.gbps("estimate")
    reference_gbps = (4585 * 857425) / REFERENCE_SWEEP_S / 1e9
    print(json.dumps({
        "metric": "effective GB/s per GPU, i386 long-haystack sweep, "
        "sustained (4585 words x 857KB, adaptive block schedule, "
        "first-offset parity enforced)",
        "value": value,
        "unit": "GB/s",
        "vs_baseline": value / reference_gbps,
        "device": device,
    }))


if __name__ == "__main__":
    main()
