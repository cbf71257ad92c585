"""Hand-written kernels against their plain XLA formulations, on the GPU.

Each pair runs the same fused device program through the public entry
point with only the kernel swapped, at the benchmark's shapes: the i386
long sweep (all 4,585 words x 857,425 B), a 1 GiB resident corpus (256
needles), and the short all-pairs sweep (4,585^2 ordered pairs).  Times
are warm, end in ``block_until_ready``, and are the median of repeats.

    python scripts/kernel_ab.py --check    # compile each pair at its real
                                           # widths, compare once, print
                                           # memory_analysis, stop
    python scripts/kernel_ab.py [--repeats 20] [--json PATH]

Every timing line carries the card's ``name, power.limit``.  The script
fails when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import sliceslice_tpu as st  # noqa: E402
from sliceslice_tpu.models.batched import _scatter_jit  # noqa: E402
from sliceslice_tpu.ops import scan_kernel, xla_backend  # noqa: E402
from sliceslice_tpu.ops.pairwise import PairwiseSearcher  # noqa: E402
from sliceslice_tpu.utils.profiling import card_line  # noqa: E402


def sweep_fns(bs, dh):
    """(kernel, xla) fused find and count sweeps of a BatchedSearcher: the
    same group tables, scatter and layout, with the scan swapped."""
    n, sizes, s = len(bs), bs._order_sizes, dh.s
    tables = tuple(
        (g.values_dev, g.masks_dev, g.ends_dev(dh.length)) for g in bs.groups
    )

    @jax.jit
    def xla_find(cols, order, tables):
        parts = [
            xla_backend.find_batched_cols(cols, v, m, e, s)
            for v, m, e in tables
        ]
        return _scatter_jit(n, sizes)(order, *parts)

    @jax.jit
    def xla_count(pw, order, tables):
        parts = [
            xla_backend.count_batched_cols(pw, v, m, e, s)
            for v, m, e in tables
        ]
        return _scatter_jit(n, sizes)(order, *parts)

    pw, cols, order = dh.windows(), dh.require_cols(), bs._order_dev
    return {
        "find": (
            (bs._sweep_fn(dh), (pw, order, tables)),
            (xla_find, (cols, order, tables)),
        ),
        "count": (
            (bs._count_sweep_fn(dh), (pw, order, tables)),
            (xla_count, (pw, order, tables)),
        ),
    }


def memchr_fns(dh, byte: int):
    """(kernel, xla): the Triton find kernel on a 1-byte table against the
    fused XLA memchr reduction that ``MemchrSearcher`` uses."""
    from sliceslice_tpu.needle import build_probe_table

    v, m, _ = build_probe_table([bytes([byte])])
    n_pad = scan_kernel.plan_block(1)
    v = jnp.asarray(np.pad(v, ((0, n_pad - 1), (0, 0))))
    m = jnp.asarray(np.pad(m, ((0, n_pad - 1), (0, 0))))
    s, end = dh.s, dh.length

    @jax.jit
    def kernel(pw, v, m):
        first = scan_kernel.find_raw(v, m, pw, s)[0]
        return jnp.where(first < end, first, st.SENTINEL)

    @jax.jit
    def xla(cols):
        return xla_backend.memchr_cols(cols, byte, end, s)

    return (kernel, (dh.windows(), v, m)), (xla, (dh.require_cols(),))


def pair_fns(words):
    """(kernel, xla): the fused short sweep with the Triton pair block and
    with the XLA scan formulation."""
    out = []
    for use_pallas in (True, False):
        ps = PairwiseSearcher(words, use_pallas=use_pallas)
        plan, pht, lh, _mi, n, h = ps._plan()
        out.append(
            (ps._fused(plan, n, h, "matrices"),
             (ps._valt, ps._mskt, ps._ln, pht, lh))
        )
    return tuple(out)


def median_ms(fn, args, repeats: int) -> float:
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def cases(seed: int):
    cfg = chip_smoke.SIZES["full"]
    hay, words = chip_smoke.load_i386(cfg)
    dh = st.preprocess(hay)
    bs = st.BatchedSearcher(words)
    bs.optimize_for(dh)
    for op, pair in sweep_fns(bs, dh).items():
        yield f"{op} i386 4585w", pair
    rhay, needles = chip_smoke.resident_workload(cfg, seed)
    rdh = st.preprocess(rhay)
    rbs = st.BatchedSearcher(needles)
    for op, pair in sweep_fns(rbs, rdh).items():
        yield f"{op} 1GiB 256n", pair
    yield "memchr 1GiB early", memchr_fns(rdh, ord("q"))
    yield "memchr 1GiB absent", memchr_fns(rdh, ord("#"))
    yield "pair 4585^2", pair_fns(sorted(words, key=len))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("kernel_ab: needs a GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}  device_kind: {jax.devices()[0].device_kind}")
    rows = []
    for name, ((kfn, kargs), (xfn, xargs)) in cases(args.seed):
        k_out = jax.block_until_ready(kfn(*kargs))
        x_out = jax.block_until_ready(xfn(*xargs))
        bad = sum(
            int((np.asarray(a) != np.asarray(b)).sum())
            for a, b in zip(jax.tree.leaves(k_out), jax.tree.leaves(x_out))
        )
        assert bad == 0, f"{name}: kernel and XLA disagree on {bad} outputs"
        if args.check:
            for label, fn, fargs in (("kernel", kfn, kargs),
                                     ("xla", xfn, xargs)):
                mem = fn.lower(*fargs).compile().memory_analysis()
                print(f"{name} [{label}] memory_analysis: {mem}")
            continue
        k_ms = median_ms(kfn, kargs, args.repeats)
        x_ms = median_ms(xfn, xargs, args.repeats)
        row = {"case": name, "kernel_ms": k_ms, "xla_ms": x_ms,
               "card": card, "repeats": args.repeats}
        rows.append(row)
        print(f"{name}: kernel {k_ms:.4f} ms  xla {x_ms:.4f} ms  "
              f"(x{x_ms / k_ms:.2f})  [{card}]", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
