"""Extended randomized differential fuzz of the real device kernels.

Complements tests/test_fuzz.py (hypothesis, CPU interpreter): this drives
the compiled kernels on a GPU (the interpreter on the CPU) through the
package boundary with heavily randomized content over a few fixed layout
shapes (fixed shapes bound the kernel compile count; content,
needle placement, and API choice carry the randomness).

Per trial mix: present-at-random-offset, single-byte-mutated (absent),
last-valid-position, segment-boundary-straddling, random-binary (incl.
NUL), and periodic needles, across widths 1..64 (every dispatch rung),
verified against the bytes.find / regex oracles for find_all and
count_all.

Usage: python scripts/fuzz_campaign.py [rounds_per_layout=10] [seed]
Exits non-zero on any mismatch.
"""

import os
import re
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sliceslice_tpu as st

KS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 17, 24, 33, 64]

LAYOUTS = [
    (4096, {}),                                   # flat XLA short path
    (4096, {"force_cols": True, "seg_rows": 32}),  # tiny tiled layout
    (50_000, {"kh": 64}),                          # single-segment tiled
    (300_000, {"kh": 64}),                         # multi-segment tiled
]


def gen_needles(hay: bytes, n_per: int, rng, seg_bytes: int) -> list:
    L = len(hay)
    needles = []
    for k in KS:
        if k > L:
            continue
        for _ in range(n_per):
            mode = rng.integers(0, 6)
            if mode == 3 and seg_bytes >= L:
                mode = 0  # single-segment layout: no boundary to straddle
            if mode == 0:
                o = int(rng.integers(0, L - k + 1))
                w = hay[o : o + k]
            elif mode == 1:
                o = int(rng.integers(0, L - k + 1))
                b = bytearray(hay[o : o + k])
                b[int(rng.integers(0, k))] ^= 0xFF
                w = bytes(b)
            elif mode == 2:
                w = hay[L - k :]
            elif mode == 3:
                # straddle the layout's actual first segment boundary
                o = max(0, min(L - k, seg_bytes - k // 2))
                w = hay[o : o + k]
            elif mode == 4:
                w = bytes(rng.integers(0, 256, k, dtype=np.uint8).tolist())
            else:
                w = (hay[3 : 3 + max(1, k // 2)] * 4)[:k]
            needles.append(w)
    return needles


def fuzz_streaming(rounds: int, rng) -> tuple:
    """Randomized windows/chunks through StreamingScanner: needles planted
    to straddle window boundaries, plus absent/binary ones; random chunk
    sizes re-chunked into overlapping windows (the exactly-once logic)."""
    from sliceslice_tpu.utils.streaming import StreamingScanner

    fails = trials = 0
    for _ in range(rounds):
        L = int(rng.integers(30_000, 200_000))
        hay = rng.integers(97, 103, L, dtype=np.uint8).tobytes()
        window = int(rng.integers(8_192, 40_000))
        needles = []
        for k in (3, 5, 8, 13, 21):
            # straddle the first window boundary and a random one
            for b in (window, window * 2 + 7):
                o = max(0, min(L - k, b - k // 2))
                needles.append(hay[o : o + k])
            o = int(rng.integers(0, L - k + 1))
            needles.append(hay[o : o + k])
            needles.append(bytes([0xFF]) + hay[o : o + k - 1])
        needles.append(hay[L - 9 :])
        if rng.integers(0, 2):
            # huge needle (> MAX_NEEDLE_LEN): per-window filter+verify,
            # planted to straddle a window boundary half the time
            from sliceslice_tpu.needle import MAX_NEEDLE_LEN

            kh_ = MAX_NEEDLE_LEN + int(rng.integers(1, 400))
            if L > kh_ + 10:
                o = (max(0, window - kh_ // 2) if rng.integers(0, 2)
                     else int(rng.integers(0, L - kh_)))
                needles.append(hay[o : o + kh_])
                needles.append(bytes(kh_))  # absent huge
        ss = StreamingScanner(needles, window_bytes=window)
        # random chunking of the byte stream
        cuts = np.sort(rng.integers(1, L, int(rng.integers(3, 40))))
        chunks = [hay[a:b] for a, b in
                  zip([0, *cuts.tolist()], [*cuts.tolist(), L])]
        base = int(rng.integers(0, 2)) * int(rng.integers(0, 2**33))
        got = ss.find_in_chunks(chunks, early_stop=bool(rng.integers(0, 2)),
                                start_offset=base)
        exp = np.array([hay.find(w) for w in needles])
        expb = np.where(exp < 0, -1, exp + base)
        bad = got != expb
        trials += len(needles)
        if bad.any():
            fails += int(bad.sum())
            i = int(np.argmax(bad))
            print("STREAM MISMATCH", L, window, needles[i], got[i], expb[i])
        # counts + positions over the same stream (file-equivalent chunks)
        from sliceslice_tpu.searcher import _host_positions, overlapping_count

        sub = needles[:: max(1, len(needles) // 6)]
        ss2 = StreamingScanner(sub, window_bytes=window)
        cnt = ss2.count_in_chunks(iter(chunks))
        cexp = [overlapping_count(hay, w) for w in sub]
        trials += len(sub)
        if list(cnt) != cexp:
            fails += 1
            print("STREAM COUNT MISMATCH", L, window)
        pos = ss2.positions_in_chunks(iter(chunks), start_offset=base)
        trials += len(sub)
        for w, pp in zip(sub, pos):
            if not np.array_equal(pp, _host_positions(hay, w) + base):
                fails += 1
                print("STREAM POSITIONS MISMATCH", L, window, w[:16])
    return trials, fails


def fuzz_sharded(rounds: int, rng) -> tuple:
    """Random content/mesh shapes through the sharded scanner (find, count
    and positions) vs the host oracles — including the forced-int64 pair
    path and boundary-straddling needles.  Uses whatever devices exist
    (8-way virtual meshes in CI; a (1,1) mesh on a single chip)."""
    import jax

    from sliceslice_tpu.parallel import ShardedBatchedSearcher, make_mesh
    from sliceslice_tpu.searcher import _host_positions, overlapping_count

    n_dev = len(jax.devices())
    shapes = [(n_dev, 1)]
    if n_dev % 2 == 0 and n_dev > 1:
        shapes.append((n_dev // 2, 2))
    fails = trials = 0
    for rnd in range(rounds):
        L = int(rng.integers(60_000, 250_000))
        lo, hi = (97, 103) if rnd % 2 else (0, 256)
        hay = rng.integers(lo, hi, L, dtype=np.uint8).tobytes()
        dh = st.preprocess(hay, kh=32, force_cols=True, seg_rows=64)
        needles = gen_needles(hay, 1, rng, dh.seg_bytes)[:24]
        exp_find = np.array([hay.find(w) for w in needles])
        for shape in shapes:
            mesh = make_mesh(shape, jax.devices()[: shape[0] * shape[1]])
            sb = ShardedBatchedSearcher(needles, mesh)
            sb.force_int64 = bool(rng.integers(0, 2))
            got = sb.find_all(dh)
            bad = got != exp_find
            trials += len(needles)
            if bad.any():
                fails += int(bad.sum())
                i = int(np.argmax(bad))
                print("SHARD FIND MISMATCH", shape, needles[i],
                      got[i], exp_find[i])
            sub = needles[::5]
            sbc = ShardedBatchedSearcher(sub, mesh)
            cnt = sbc.count_all(dh)
            cexp = np.array([overlapping_count(hay, w) for w in sub])
            trials += len(sub)
            if (cnt != cexp).any():
                fails += int((cnt != cexp).sum())
                print("SHARD COUNT MISMATCH", shape)
            pos = sbc.positions_all(dh, gather=bool(rng.integers(0, 2)))
            trials += len(sub)
            for w, p in zip(sub, pos):
                if not np.array_equal(p, _host_positions(hay, w)):
                    fails += 1
                    print("SHARD POSITIONS MISMATCH", shape, w)
            if rng.integers(0, 2):
                # huge needle over the mesh (prefix filter + local verify)
                from sliceslice_tpu.needle import MAX_NEEDLE_LEN

                kh_ = MAX_NEEDLE_LEN + int(rng.integers(1, 300))
                if L > kh_ + 10:
                    o = int(rng.integers(0, L - kh_))
                    hsub = [hay[o : o + kh_], bytes(kh_), needles[0]]
                    sbh = ShardedBatchedSearcher(hsub, mesh)
                    hf = sbh.find_all(dh)
                    hexp = np.array([hay.find(w) for w in hsub])
                    trials += len(hsub)
                    if (hf != hexp).any():
                        fails += int((hf != hexp).sum())
                        print("SHARD HUGE MISMATCH", shape, o, kh_)
    return trials, fails


def fuzz_pairwise(rounds: int, rng) -> tuple:
    """Random mixed-length word lists (binary bytes, shared prefixes,
    duplicates, 1-char words) through PairwiseSearcher.first_matrix vs the
    bytes.find oracle."""
    from sliceslice_tpu.ops.pairwise import PairwiseSearcher

    fails = trials = 0
    for _ in range(rounds):
        n = int(rng.integers(20, 120))
        words = []
        for _ in range(n):
            k = int(rng.integers(1, 28))
            if rng.integers(0, 4) == 0 and words:
                base = words[int(rng.integers(0, len(words)))]
                w = (base + bytes(rng.integers(0, 256, k).tolist()))[:k]
            else:
                lo, hi = (97, 105) if rng.integers(0, 2) else (0, 256)
                w = bytes(rng.integers(lo, hi, k, dtype=np.uint8).tolist())
            words.append(w)
        words.sort(key=len)
        got = PairwiseSearcher(words).first_matrix(words)
        exp = np.array([[h.find(nd) for h in words] for nd in words])
        bad = got != exp
        trials += got.size
        if bad.any():
            fails += int(bad.sum())
            i, j = np.argwhere(bad)[0]
            print("PAIR MISMATCH", words[i], words[j], got[i, j], exp[i, j])
    return trials, fails


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 20260818
    rng = np.random.default_rng(seed)
    fails = trials = 0
    for L, kw in LAYOUTS:
        for rnd in range(rounds):
            hay = (
                rng.integers(0, 256, L, dtype=np.uint8).tobytes()
                if rnd % 2
                else rng.integers(97, 103, L, dtype=np.uint8).tobytes()
            )
            dh = st.preprocess(hay, **kw)
            needles = gen_needles(hay, 4, rng, dh.seg_bytes)
            got = st.BatchedSearcher(needles).find_all(dh)
            exp = np.array([hay.find(w) for w in needles])
            bad = got != exp
            trials += len(needles)
            if bad.any():
                fails += int(bad.sum())
                i = int(np.argmax(bad))
                print("FIND MISMATCH", L, kw, needles[i], got[i], exp[i])
            sub = needles[::7]
            cnt = st.BatchedSearcher(sub).count_all(dh)
            cexp = np.array([
                len(re.findall(b"(?=" + re.escape(w) + b")", hay))
                for w in sub
            ])
            trials += len(sub)
            if (cnt != cexp).any():
                fails += int((cnt != cexp).sum())
                print("COUNT MISMATCH", L, kw)
    st_trials, st_fails = fuzz_streaming(max(2, rounds // 2), rng)
    pw_trials, pw_fails = fuzz_pairwise(max(2, rounds // 2), rng)
    sh_trials, sh_fails = fuzz_sharded(max(2, rounds // 3), rng)
    trials += st_trials + pw_trials + sh_trials
    fails += st_fails + pw_fails + sh_fails
    print(f"fuzz campaign: {trials} trials ({st_trials} streaming, "
          f"{pw_trials} pairwise, {sh_trials} sharded) over "
          f"{len(LAYOUTS)} layouts, {fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
