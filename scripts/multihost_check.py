"""Execute the multi-host path FOR REAL: 2 jax.distributed processes on CPU.

The reference sets the bar of *executing* cross-platform code paths rather
than leaving them compile-only (its wasm backend runs under wasmtime in CI,
.github/workflows/check.yml); the analogue here is driving
``jax.distributed.initialize`` + ``assemble_global_corpus`` +
``sharded_find_cols``/``sharded_count_cols`` across two real OS processes
(4 virtual CPU devices each -> one 8-device global mesh) and asserting
parity with a host oracle.  No process ever materializes the full corpus.

Launcher mode (no args): spawns the two workers and checks exit codes.
Worker mode:  python scripts/multihost_check.py <port> <process_id>
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NPROC = 2
DEVS_PER_PROC = 4
CORPUS_BYTES = 600_000
SEG_ROWS = 96  # small segments so every device gets several


def corpus_chunk(base: int, size: int) -> bytes:
    """Deterministic corpus generator — any process can produce any range
    without holding the whole corpus."""
    import numpy as np

    rng = np.random.default_rng(77)
    # Cheap but deterministic: one global draw is fine at this test size;
    # slice the requested range.
    full = rng.integers(97, 105, (CORPUS_BYTES,), dtype=np.uint8)
    return full[base : base + size].tobytes()


def worker(port: int, pid: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", DEVS_PER_PROC)

    import numpy as np

    import sliceslice_tpu  # noqa: F401
    from sliceslice_tpu.needle import MAX_NEEDLE_LEN, build_probe_table
    from sliceslice_tpu.ops.layout import LANES, round_up
    from sliceslice_tpu.parallel import (
        ShardedBatchedSearcher,
        gather_positions,
        sharded_count_cols,
        sharded_find_cols,
        sharded_positions,
    )
    from sliceslice_tpu.parallel.distributed import (
        assemble_global_corpus,
        global_mesh,
        initialize,
    )

    initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=NPROC,
        process_id=pid,
    )
    assert jax.process_count() == NPROC, jax.process_count()
    assert jax.device_count() == NPROC * DEVS_PER_PROC
    mesh = global_mesh()

    # Each process builds ONLY its contiguous half (padded to whole segments
    # on the final host), plus a peek past its range: kh bytes feed the halo
    # rows; the longer tail lets huge-needle verify read across the process
    # boundary.  The global segment count rounds to the data axis.
    kh = 64  # >= 63: the huge-needle 64-byte prefix filter's halo need
    k_huge = MAX_NEEDLE_LEN + 500
    seg = SEG_ROWS * LANES
    n_data = mesh.shape["data"]
    g_global = round_up(-(-CORPUS_BYTES // seg), NPROC * (n_data // NPROC))
    g_global = round_up(g_global, n_data)
    g_local = g_global // NPROC
    lo = pid * g_local * seg
    hi = min((pid + 1) * g_local * seg, CORPUS_BYTES)
    local = corpus_chunk(lo, max(hi - lo, 0))
    peek = corpus_chunk(hi, max(kh, k_huge - 1)) if hi < CORPUS_BYTES else b""
    gc = assemble_global_corpus(
        local, peek, CORPUS_BYTES, SEG_ROWS, kh, mesh, g_local=g_local
    )
    assert gc.g == g_global
    assert gc.local_base == lo and gc.local_bytes is not None

    # Needles: known plants (incl. one straddling the PROCESS boundary),
    # an absent one, and a high-count one.
    mid = NPROC // 2 * g_local * seg  # the cross-process shard boundary
    probes = [
        (corpus_chunk(10, 12), 12),
        (corpus_chunk(mid - 5, 10), 10),  # straddles process 0 / process 1
        (corpus_chunk(CORPUS_BYTES - 8, 8), 8),
        (b"ZZZZ!", 5),
        (corpus_chunk(0, 2), 2),
    ]
    needles = [nd for nd, _ in probes]
    values, masks, lengths = build_probe_table(needles)
    ends = np.maximum(CORPUS_BYTES - lengths.astype(np.int64) + 1, 0)

    got = np.asarray(sharded_find_cols(gc, values, masks, ends, mesh))
    cnt = np.asarray(sharded_count_cols(gc, values, masks, ends, mesh))

    # Oracle on the full corpus (test-only; workers CAN generate it here).
    from sliceslice_tpu.searcher import _host_positions, overlapping_count

    full = corpus_chunk(0, CORPUS_BYTES)
    for nd, o, c in zip(needles, got, cnt):
        exp = full.find(nd)
        eo = -1 if exp < 0 else exp
        oo = -1 if o >= 2**31 - 1 else int(o)
        assert oo == eo, (nd, oo, eo)
        assert int(c) == overlapping_count(full, nd), (nd, int(c))

    # Positions: per-process decode covers only addressable shards;
    # gather_positions merges to the GLOBAL sorted list on every process.
    per_proc = sharded_positions(gc, values, masks, ends, mesh)
    merged = gather_positions(per_proc)
    for nd, p in zip(needles, merged):
        assert list(p) == list(_host_positions(full, nd)), (nd, p[:5])
    n_local = sum(p.size for p in per_proc)
    n_glob = sum(p.size for p in merged)
    assert 0 < n_local < n_glob, (n_local, n_glob)  # gather added remote hits

    # Huge needle straddling the process boundary: sharded prefix filter +
    # process-local verify (reads into the peek), allgather-reduced.
    huge_probes = [
        full[mid - 900 : mid - 900 + k_huge],  # spans both processes
        full[1_000 : 1_000 + k_huge],          # inside process 0
        bytes(k_huge),                         # absent
    ]
    sb = ShardedBatchedSearcher(
        huge_probes + [corpus_chunk(10, 12)], mesh
    )
    hf = sb.find_all(gc)
    hc = sb.count_all(gc)
    hp = sb.positions_all(gc, gather=True)
    for nd, f, c, p in zip(huge_probes + [corpus_chunk(10, 12)], hf, hc, hp):
        assert int(f) == full.find(nd), (len(nd), int(f), full.find(nd))
        assert int(c) == overlapping_count(full, nd), (len(nd), int(c))
        assert list(p) == list(_host_positions(full, nd)), len(nd)

    # Regression: process_allgather under 32-bit jax silently truncates
    # int64 host values; allgather_i64 must carry them exactly (two limbs).
    from sliceslice_tpu.parallel.distributed import allgather_i64

    big = np.asarray([2**40 + pid, -1, 2**31 + 5], np.int64)
    rows = allgather_i64(big)
    assert rows.tolist() == [
        [2**40 + q, -1, 2**31 + 5] for q in range(NPROC)
    ], rows.tolist()

    print(f"process {pid}: multihost parity ok — find/count/positions(+gather)"
          f"/huge({k_huge}B, cross-process straddle), {len(needles)} needles, "
          f"mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}")


def main() -> None:
    if len(sys.argv) == 3:
        worker(int(sys.argv[1]), int(sys.argv[2]))
        return
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(port), str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(NPROC)
    ]
    ok = True
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        tail = b"\n".join(out.splitlines()[-8:]).decode(errors="replace")
        if p.returncode != 0:
            ok = False
            print(f"-- worker {i} FAILED (rc={p.returncode}) --\n{tail}")
        else:
            print(tail.splitlines()[-1] if tail else f"worker {i} ok")
    if not ok:
        sys.exit(1)
    print("multihost_check: 2-process sharded scan parity ok")


if __name__ == "__main__":
    main()
