"""Streaming throughput benchmark: sustained GB/s of files streamed from the
host through ``utils/streaming.StreamingScanner``.

Each timed stream runs in its own child process, strictly one at a time,
and the parent never imports jax: a JAX process reserves most of the
card's memory when it first uses it, so only one may hold the card at a
time.  Each child checks its own backend and fails without a GPU.  Per
stream it records the host-to-device upload rate it measured, the stream's
wall time and GB/s, and the scanner's own attribution (read/prep/upload/
dispatch/drain seconds and p50/p90 window latency, ``StreamingScanner.
stats``).

Usage: python scripts/stream_bench.py [long_bytes] [--fast]
       python scripts/stream_bench.py --child <mode> <bytes> (internal)
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

PATH = os.path.join(tempfile.gettempdir(), "sliceslice_stream_bench.bin")
WINDOW = 32 << 20


def ensure_corpus(size: int) -> str:
    """Exact-``size`` random file (a stream scans its whole file, so each
    measured size needs its own); sizes share one master's prefix bytes."""
    if not (os.path.exists(PATH) and os.path.getsize(PATH) >= size):
        rng = np.random.default_rng(42)
        with open(PATH, "wb") as f:
            left = max(size, 1 << 30)
            while left:
                n = min(left, 256 << 20)
                f.write(rng.bytes(n))
                left -= n
    if os.path.getsize(PATH) == size:
        return PATH
    sized = f"{PATH[:-4]}_{size}.bin"
    if not (os.path.exists(sized) and os.path.getsize(sized) == size):
        with open(PATH, "rb") as src, open(sized, "wb") as dst:
            left = size
            while left:
                n = min(left, 256 << 20)
                dst.write(src.read(n))
                left -= n
    return sized


def draw_needles(path: str, size: int):
    """48 mixed-length substrings drawn from the corpus + an absent decoy."""
    with open(path, "rb") as f:
        head = f.read(4 << 20)
        f.seek(size // 2)
        mid = f.read(1 << 20)
    rng = np.random.default_rng(7)
    return [
        bytes(src[o : o + k])
        for src in (head, mid)
        for k in (8, 12, 16, 24, 33, 64)
        for o in map(int, rng.integers(0, len(src) - 64, (4,)))
    ] + [b"\x00absent!" + bytes(8) + b"q" * 9]


def upload_probe(window: int = 64 << 20, reps: int = 5) -> dict:
    """Host->device upload rate of one window-sized buffer, each rep ending
    in a dependent 8-byte readback so the transfer has surely landed."""
    import jax
    import jax.numpy as jnp

    buf = np.random.default_rng(0).integers(0, 255, (window,), dtype=np.uint8)
    probe = jax.jit(lambda x: x[:8].astype(jnp.int32).sum())
    int(np.asarray(probe(jnp.asarray(buf))))  # compile + first transfer
    t0 = time.perf_counter()
    for i in range(reps):
        buf[:64] = i  # content changes so nothing can be deduplicated
        int(np.asarray(probe(jnp.asarray(buf))))
    return {"upload_gbps": round(window * reps / (time.perf_counter() - t0) / 1e9, 3)}


def child(mode: str, size: int) -> dict:
    """Run ONE timed stream: upload probe -> warmup (exact shapes) -> the
    stream, with spot parity on the result."""
    import jax

    from sliceslice_tpu.utils.streaming import StreamingScanner

    if jax.default_backend() != "gpu":
        raise SystemExit(f"stream_bench: needs a GPU, JAX found "
                         f"{jax.default_backend()!r}")
    res = {"mode": mode, "window": WINDOW}
    res.update(upload_probe())
    path = ensure_corpus(size)
    needles = draw_needles(path, size)
    if mode == "positions":
        needles = needles[:8] + needles[-1:]  # bitmap readback is per needle
    sc = StreamingScanner(needles, window_bytes=WINDOW)
    t0 = time.perf_counter()
    sc.warmup(modes=(mode,))
    res.update({
        "bytes": size, "needles": len(needles),
        "warmup_s": round(time.perf_counter() - t0, 1),
    })
    t0 = time.perf_counter()
    if mode == "find":
        out = sc.find_in_file(path, early_stop=False)
        # Spot parity: the drawn needles exist, the decoy does not.
        assert int(out[-1]) == -1
        assert all(int(x) >= 0 for x in out[:-1])
    elif mode == "count":
        out = sc.count_in_file(path)
        assert int(out[-1]) == 0
        assert all(int(x) >= 1 for x in out[:-1])
    elif mode == "positions":
        out = sc.positions_in_file(path)
        assert out[-1].size == 0
        assert all(p.size >= 1 and (np.diff(p) > 0).all() for p in out[:-1])
    else:
        raise SystemExit(f"unknown child mode {mode}")
    wall = time.perf_counter() - t0
    res["wall_s"] = round(wall, 3)
    res["gbps"] = round(size / wall / 1e9, 3)
    res["stats"] = sc.stats_summary()
    res["device"] = {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }
    return res


def _spawn(mode: str, size: int, timeout: int = 1200) -> dict:
    """One serialized fresh-process measurement (the parent holds no
    device, so the child owns the card alone)."""
    ensure_corpus(size)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", mode,
         str(size)],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
    )
    if proc.returncode:
        raise SystemExit(
            f"stream_bench child {mode} failed (rc={proc.returncode}): "
            f"{proc.stderr[-800:]}"
        )
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run(long_bytes: int, fast: bool = False) -> dict:
    short = 256 << 20
    res = {"window_bytes": WINDOW}
    res["find_long"] = _spawn("find", long_bytes)
    res["count_long"] = _spawn("count", long_bytes if not fast else short)
    res["find_short"] = [_spawn("find", short) for _ in range(1 if fast else 2)]
    res["positions_small"] = _spawn("positions", 64 << 20)
    fl = res["find_long"]
    res["upload_fraction"] = round(fl["gbps"] / fl["upload_gbps"], 3)
    return res


def main():
    if "--child" in sys.argv:
        i = sys.argv.index("--child")
        print(json.dumps(child(sys.argv[i + 1], int(sys.argv[i + 2]))))
        return
    long_bytes = 1 << 30
    for a in sys.argv[1:]:
        if a.isdigit():
            long_bytes = int(a)
    res = run(long_bytes, fast="--fast" in sys.argv)
    fl, cl = res["find_long"], res["count_long"]
    print(
        f"stream find : {fl['gbps']} GB/s ({fl['wall_s']}s for "
        f"{fl['bytes'] / 2**30:.1f} GiB; upload {fl['upload_gbps']} GB/s)\n"
        f"stream count: {cl['gbps']} GB/s\n"
        f"positions   : {res['positions_small']['gbps']} GB/s",
        file=sys.stderr,
    )
    print(json.dumps(res))


if __name__ == "__main__":
    main()
