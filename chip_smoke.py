"""End-to-end smoke test of sliceslice on one NVIDIA GPU.

Drives the main paths once, through the entry points a user calls, at the
sizes users run: the i386 conformance corpus with all 4,585 words (long
and short sweeps), a 1 GiB corpus resident in device memory (larger than
the card's 50 MB L2), every dispatch arm of ``DynamicSearcher``, the grep
CLI, a stream of more than 4.5 GiB from the host, and the gpu-marked tests
(compiled kernels against their XLA references).  Every phase is checked
exactly against an oracle independent of the code under test
(``bytes.find``, ``overlapping_count`` / ``_host_positions``, and the C++
SWAR tier where it is built): zero mismatches, or the run fails.

    python chip_smoke.py                   # one GPU, every phase
    python chip_smoke.py --cards 4         # the sharded path on 4 GPUs only
    python chip_smoke.py --cpu-rehearsal   # every phase, tiny, on the CPU

The script fails (non-zero exit, no result line) when JAX finds no GPU.
The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402

import sliceslice_tpu as st  # noqa: E402
from sliceslice_tpu.searcher import _host_positions, overlapping_count  # noqa: E402
from sliceslice_tpu.utils import corpus_gen, native  # noqa: E402
from sliceslice_tpu.utils.profiling import card_line  # noqa: E402

#: Full-size and rehearsal sizes of every phase.
SIZES = {
    "full": dict(
        hay_bytes=None, n_words=None, short_words=None, positions_words=64,
        resident_bytes=2**30, resident_words=128, resident_planted=64,
        resident_absent=64, resident_detail=16, stream_bytes=int(4.6 * 2**30),
        stream_window=128 * 2**20,
    ),
    "rehearsal": dict(
        hay_bytes=96 * 1024, n_words=96, short_words=64, positions_words=16,
        resident_bytes=2 * 2**20, resident_words=24, resident_planted=12,
        resident_absent=12, resident_detail=6, stream_bytes=3 * 2**20,
        stream_window=2**20,
    ),
}


class CompileClock:
    """Seconds JAX spent in backend compilation (XLA and Triton kernels)."""

    def __init__(self):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.total += duration


def _none_if_absent(off) -> int:
    return int(off) if off is not None else -1


def oracle_find(hay: bytes, needles) -> np.ndarray:
    """First offsets (-1 absent): the C++ SWAR tier over worker threads when
    it is built (ctypes releases the GIL), else ``bytes.find``."""
    if native.available():
        def one(nd):
            if not nd:
                return 0
            return _none_if_absent(native.swar_find(hay, nd))
    else:
        def one(nd):
            return hay.find(nd)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        return np.asarray(list(ex.map(one, needles)), np.int64)


def check(name: str, got, exp) -> int:
    """Mismatch count of two equal-length sequences; raises when non-zero."""
    got = np.asarray(got)
    exp = np.asarray(exp)
    assert got.shape == exp.shape, (name, got.shape, exp.shape)
    bad = int((got != exp).sum())
    assert bad == 0, f"{name}: {bad} mismatches"
    return bad


def check_lists(name: str, got, exp) -> int:
    bad = sum(
        1 for g, e in zip(got, exp) if not np.array_equal(np.asarray(g), e)
    )
    assert len(got) == len(exp) and bad == 0, f"{name}: {bad} mismatches"
    return bad


def load_i386(cfg):
    hay = open(os.path.join(REPO, "data/i386.txt"), "rb").read()
    words = [
        w for w in open(os.path.join(REPO, "data/words.txt"), "rb")
        .read().split(b"\n") if w
    ]
    if cfg["hay_bytes"]:
        hay = hay[: cfg["hay_bytes"]]
    if cfg["n_words"]:
        words = words[:: max(1, len(words) // cfg["n_words"])][: cfg["n_words"]]
    return hay, words


def resident_workload(cfg, seed: int):
    """The resident-corpus phase's data: seeded lowercase filler with
    uppercase needles planted at random offsets, and a needle list of
    dictionary words, planted needles and absent uppercase needles."""
    rng = np.random.default_rng(seed)
    _, words = load_i386(SIZES["full"])
    total = cfg["resident_bytes"]

    def upper(k):
        return bytes(rng.integers(65, 91, (int(k),), dtype=np.uint8))

    picks = rng.choice(len(words), cfg["resident_words"], replace=False)
    planted = [upper(k) for k in rng.integers(1, 25, cfg["resident_planted"])]
    absent = [upper(k) for k in rng.integers(8, 25, cfg["resident_absent"])]
    offsets = rng.integers(0, total - 32, len(planted))
    hay = corpus_gen.planted_corpus(
        total, list(zip(offsets.tolist(), planted)), seed
    )
    return hay, [words[i] for i in picks] + planted + absent


# -- phases ------------------------------------------------------------------


def phase_long(cfg, seed):
    """i386 x every word: find, count and positions after optimize_for
    (the order of the sustained benchmark)."""
    hay, words = load_i386(cfg)
    dh = st.preprocess(hay)
    bs = st.BatchedSearcher(words)
    exp_find = oracle_find(hay, words)
    bad = check("long find (cold)", bs.find_all(dh), exp_find)
    bs.optimize_for(dh)
    bad += check("long find", bs.find_all(dh), exp_find)
    bad += check(
        "long count", bs.count_all(dh),
        [overlapping_count(hay, w) for w in words],
    )
    sub = words[:: max(1, len(words) // cfg["positions_words"])]
    sub = sub[: cfg["positions_words"]]
    bad += check_lists(
        "long positions", st.BatchedSearcher(sub).positions_all(dh),
        [_host_positions(hay, w) for w in sub],
    )
    return f"{len(words)} words x {len(hay)} B, positions {len(sub)}", bad


def phase_short(cfg, seed):
    """Every ordered pair of the sorted word list (the reference's short
    sweep): first offsets."""
    _, words = load_i386(cfg)
    if cfg["short_words"]:
        words = words[: cfg["short_words"]]
    ws = sorted(words, key=len)
    got = np.asarray(st.PairwiseSearcher(ws).first_matrix())
    if native.available():
        contains = native.swar_pairwise(ws)
        exp = np.full(contains.shape, -1, np.int64)
        for i, j in zip(*np.nonzero(contains)):
            exp[i, j] = ws[j].find(ws[i])
    else:
        exp = np.asarray([[h.find(nd) for h in ws] for nd in ws])
    return f"{got.size} ordered pairs", check("short first", got, exp)


def phase_resident(cfg, seed):
    """A corpus larger than L2 kept in device memory: find for every
    needle, count and positions for a subset."""
    hay, needles = resident_workload(cfg, seed)
    dh = st.preprocess(hay)
    bad = check(
        "resident find", st.BatchedSearcher(needles).find_all(dh),
        oracle_find(hay, needles),
    )
    # Needles of 4+ bytes: a 1-letter word matches ~40M times in a GiB,
    # which the Python oracle would take minutes to count.
    rng = np.random.default_rng(seed + 1)
    longer = [nd for nd in needles if len(nd) >= 4]
    sub = [longer[i] for i in rng.choice(
        len(longer), cfg["resident_detail"], replace=False)]
    bs = st.BatchedSearcher(sub)
    bad += check(
        "resident count", bs.count_all(dh),
        [overlapping_count(hay, nd) for nd in sub],
    )
    bad += check_lists(
        "resident positions", bs.positions_all(dh),
        [_host_positions(hay, nd) for nd in sub],
    )
    return (
        f"{len(hay)} B, {dh.g} segments, find {len(needles)}, "
        f"count+positions {len(sub)}"
    ), bad


def phase_dispatch(cfg, seed):
    """DynamicSearcher's arms (k = 0, 1, 2..16, 17..32, > 32, huge) and the
    boundary cases, over the i386 corpus already laid out on device."""
    hay, _ = load_i386(cfg)
    dh = st.preprocess(hay)
    rng = np.random.default_rng(seed)
    seg = dh.seg_bytes
    needles = [b"", hay[100:101], b"\x00"]
    for k in list(range(2, 17)) + [17, 24, 32, 33, 48, 64]:
        i = int(rng.integers(0, len(hay) - k))
        needles.append(hay[i : i + k])
    needles += [
        hay[-7:], hay[-1:],  # last valid position
        hay[len(hay) // 3 : len(hay) // 3 + 2100],  # huge (> 2,048 B)
        hay[-2500:],
    ]
    if dh.g >= 2:
        needles += [hay[seg - 5 : seg + 5], hay[seg - 1 : seg + 3]]
    bad = 0
    for nd in needles:
        ds = st.DynamicSearcher(nd)
        f = ds.find(dh)
        bad += check(f"find k={len(nd)}", _none_if_absent(f), hay.find(nd))
        bad += check(f"count k={len(nd)}", ds.count_in(dh),
                     overlapping_count(hay, nd))
        if nd:
            bad += check_lists(f"positions k={len(nd)}", [ds.positions(dh)],
                               [_host_positions(hay, nd)])
    return f"{len(needles)} needles over {len(hay)} B", bad


def phase_cli(cfg, seed):
    """The grep CLI in-process: dynamic, batched, count and positions."""
    from sliceslice_tpu import cli

    path = os.path.join(REPO, "data/i386.txt")
    hay = open(path, "rb").read()
    needles = [b"Protected Mode", b"interrupt", b"EFLAGS", b"zzqzzq"]

    def run(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args)
        return rc, buf.getvalue().splitlines()

    bad = 0
    rc, out = run(["dynamic", "Protected Mode", path])
    bad += check("cli dynamic", [rc, out[0]],
                 [0, f"{path}: match at {hay.find(needles[0])}"])
    arg = ",".join(nd.decode() for nd in needles)
    rc, out = run(["batched", arg, path])
    bad += check("cli batched", out, [
        f"{path}: {nd.decode()}: "
        + (f"match at {hay.find(nd)}" if nd in hay else "no match")
        for nd in needles
    ])
    rc, out = run(["count", arg, path])
    bad += check("cli count", out, [
        f"{path}: {nd.decode()}: {overlapping_count(hay, nd)}"
        for nd in needles
    ])
    rc, out = run(["positions", arg, path])
    exp = []
    for nd in needles:
        pos = _host_positions(hay, nd)
        shown = ",".join(map(str, pos[:100].tolist()))
        more = f" (+{pos.size - 100} more)" if pos.size > 100 else ""
        exp.append(f"{path}: {nd.decode()}: "
                   f"{shown if pos.size else 'no match'}{more}")
    bad += check("cli positions", out, exp)
    return "dynamic, batched, count, positions on data/i386.txt", bad


def phase_stream(cfg, seed):
    """A host stream larger than 4.5 GiB through StreamingScanner, needles
    planted past 2**31 and 2**32: exact int64 first offsets."""
    total = cfg["stream_bytes"]
    plants = corpus_gen.boundary_plants(total)
    if total < 2**31:
        # Rehearsal: the same needles, spread evenly over the small stream.
        names = [nd for _, nd in corpus_gen.boundary_plants(2**33)]
        plants = [((i + 1) * total // (len(names) + 1), nd)
                  for i, nd in enumerate(names)]
    expected = corpus_gen.first_offsets(plants)
    needles = sorted(expected) + [b"ABSENT-NEEDLE-Z!"]
    sc = st.StreamingScanner(needles, window_bytes=cfg["stream_window"])
    sc.warmup(modes=("find",))
    got = sc.find_in_chunks(
        corpus_gen.planted_chunks(total, plants, seed,
                                  chunk=min(corpus_gen.CHUNK, total)),
        early_stop=False,
    )
    exp = [expected.get(nd, -1) for nd in needles]
    return (
        f"{total} B in {sc.stats['windows']} windows, {len(needles)} needles"
    ), check("stream find", got, exp)


def phase_gpu_tests(cfg, seed):
    """The gpu-marked tests (compiled kernels vs XLA references)."""
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    counter = Count()
    rc = pytest.main(
        [os.path.join(REPO, "tests"), "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        plugins=[counter],
    )
    assert rc == 0 and counter.passed > 0, f"gpu tests rc={rc}"
    return f"{counter.passed} tests", 0


def phase_sharded(cfg, seed, mesh_shapes=((4, 1), (2, 2))):
    """ShardedBatchedSearcher and the sharded entry points on 4-device
    meshes, against the single-device BatchedSearcher and the oracle."""
    from sliceslice_tpu.needle import build_probe_table
    from sliceslice_tpu.parallel import (
        ShardedBatchedSearcher,
        make_mesh,
        sharded_count_cols,
        sharded_find_cols,
        sharded_positions,
    )

    devices = jax.devices()[:4]
    bad = 0
    hay_i, words = load_i386(cfg)
    hay_r, needles_r = resident_workload(cfg, seed)
    for label, hay, needles in (("i386", hay_i, words),
                                ("resident", hay_r, needles_r)):
        dh = st.preprocess(hay)
        single = st.BatchedSearcher(needles)
        one_find = single.find_all(dh)
        one_count = single.count_all(dh)
        bad += check(f"{label} single find", one_find,
                     oracle_find(hay, needles))
        sub = needles[:: max(1, len(needles) // 16)][:16]
        exp_pos = [_host_positions(hay, nd) for nd in sub]
        vals, msks, lens = build_probe_table(sub)
        ends = np.maximum(len(hay) - lens + 1, 0)
        for shape in mesh_shapes:
            mesh = make_mesh(shape, devices)
            sb = ShardedBatchedSearcher(needles, mesh)
            bad += check(f"{label} {shape} find", sb.find_all(dh), one_find)
            bad += check(f"{label} {shape} count", sb.count_all(dh),
                         one_count)
            first = np.asarray(sharded_find_cols(dh, vals, msks, ends, mesh))
            first = np.where(first >= st.SENTINEL, -1, first)
            bad += check(f"{label} {shape} sharded_find_cols", first,
                         one_find[:: max(1, len(needles) // 16)][:16])
            bad += check(
                f"{label} {shape} sharded_count_cols",
                np.asarray(sharded_count_cols(dh, vals, msks, ends, mesh)),
                one_count[:: max(1, len(needles) // 16)][:16],
            )
            bad += check_lists(
                f"{label} {shape} sharded_positions",
                sharded_positions(dh, vals, msks, ends, mesh), exp_pos,
            )
    return (
        f"meshes {list(mesh_shapes)}; i386 {len(words)} words, "
        f"resident {len(hay_r)} B x {len(needles_r)} needles"
    ), bad


PHASES = [
    ("long", phase_long),
    ("short", phase_short),
    ("resident", phase_resident),
    ("dispatch", phase_dispatch),
    ("cli", phase_cli),
    ("stream", phase_stream),
    ("gpu_tests", phase_gpu_tests),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="every phase at tiny sizes on the CPU (tests)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    devices = jax.devices()
    platform = devices[0].platform
    want = "cpu" if args.cpu_rehearsal else "gpu"
    if platform != want:
        print(f"chip_smoke: needs platform {want!r}, JAX found {platform!r}",
              file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: needs {args.cards} devices, found "
              f"{len(devices)}", file=sys.stderr)
        return 2
    cfg = SIZES["rehearsal" if args.cpu_rehearsal else "full"]
    card = "no card (cpu rehearsal)" if args.cpu_rehearsal else card_line()
    print(f"card: {card}")
    print(f"device_kind: {devices[0].device_kind}  jax: {jax.__version__}")
    if args.cards == 4:
        phases = [("sharded", phase_sharded)]
    elif args.cpu_rehearsal:
        phases = [p for p in PHASES if p[0] != "gpu_tests"]
    else:
        phases = PHASES
    clock = CompileClock()
    for name, fn in phases:
        c0, t0 = clock.total, time.perf_counter()
        sizes, mismatches = fn(cfg, args.seed)
        print(
            f"phase {name}: {sizes}; mismatches {mismatches}; "
            f"compile_s {clock.total - c0:.2f}; "
            f"wall_s {time.perf_counter() - t0:.2f}",
            flush=True,
        )
    print(json.dumps({"ok": True, "device": {
        "platform": platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
