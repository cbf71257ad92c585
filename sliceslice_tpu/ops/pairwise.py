"""Pairwise containment sweep — the short-haystack workload.

The reference's short-haystack bench/conformance sweep searches every
dictionary word in every same-or-longer word, one `search_in` call per pair
(~10.5M calls, bench/benches/i386.rs:16-155, tests/i386.rs:46-59).  The device
re-expression evaluates a whole (needle-block x haystack-block) tile of pairs
per device op, using the same packed-window probes as the long-haystack
kernel: needle n is ``T = ceil(k/4)`` masked uint32 window compares, and for
candidate position i, probe slot t is one fused broadcast compare

    eq[n, h] = (win32(h, i + 4t) & mask[t, n]) == value[t, n]

ANDed over slots (a mask-0 slot is trivially true, so mixed lengths need no
extra masking), then validity ``i <= len(h) - len(n)`` and a min reduction
over i.  Work is O(N*H*I*ceil(J/4)) vector ops — 4x fewer inner steps than
byte-at-a-time — with no per-pair dispatch at all.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import config

#: Block edge for the pair matrix (tile = BLOCK x BLOCK pairs).  Finer
#: blocks give the static plan tighter per-block (tn, mi) buckets and more
#: skipped all-false blocks on length-sorted word lists; dispatch stays
#: flat because the whole plan is one fused jit program.
BLOCK = 512


def pack_words(words: Sequence[bytes], width: int):
    """Pad words into (W, width) uint8 plus lengths (W,) int32."""
    arr = np.zeros((len(words), width), dtype=np.uint8)
    lens = np.zeros((len(words),), dtype=np.int32)
    for i, w in enumerate(words):
        if len(w) > width:
            raise ValueError(f"word {i} longer than width={width}")
        arr[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
        lens[i] = len(w)
    return arr, lens


def max_len(words: Sequence[bytes]) -> int:
    return max((len(w) for w in words), default=1) or 1


@functools.partial(jax.jit, static_argnums=(5, 6))
def _pair_block(valt, mskt, ln, pht, lh, tn, mi):
    """Probe-table needle block x packed-window haystack block:
    valt/mskt (tn, Nb) u32, pht (>= mi + 4*tn - 4 rows, Hb) u32 ->
    contains (Nb, Hb) bool, first (Nb, Hb) int32 (mi = no-match sentinel).

    Scans candidate position i with a small (Nb, Hb) carry; the probe chain
    is statically unrolled so XLA fuses it into one pass per i.  Windows
    live along rows, so the dynamic ``i + 4t`` row extraction is cheap;
    mask-0 slots are trivially true (mixed lengths, empty needles included).
    """
    nb = valt.shape[1]
    hb = pht.shape[1]
    limit = lh[None, :] - ln[:, None]  # (Nb, Hb): valid i <= len(h)-len(n)

    def i_step(first, i):
        m = None
        for t in range(tn):
            hrow = jax.lax.dynamic_index_in_dim(
                pht, i + 4 * t, axis=0, keepdims=False
            )  # (Hb,) uint32 windows
            # Pre-masked values (needle.py contract): 2-op masked compare.
            eq = (hrow[None, :] & mskt[t][:, None]) == valt[t][:, None]
            m = eq if m is None else jnp.logical_and(m, eq)
        # i runs DESCENDING, so a plain select keeps the smallest matching
        # i — one pass instead of a guarded min.  Validity (i <= limit) is
        # a PREFIX of the scan range, so the smallest raw match is valid
        # iff it is <= limit: filtered once after the loop, not per step.
        return jnp.where(m, i, first), None

    first0 = jnp.full((nb, hb), mi, dtype=jnp.int32)
    first, _ = jax.lax.scan(
        i_step, first0, jnp.arange(mi - 1, -1, -1, dtype=jnp.int32)
    )
    first = jnp.where(first <= limit, first, jnp.int32(mi))
    return first < mi, first


#: Triton pair-block tile: PAIR_BN needles x PAIR_BH haystack words per
#: program, the whole (PAIR_BN, PAIR_BH) first-offset tile held in
#: registers across the candidate-position loop (the XLA formulation above
#: writes its (Nb, Hb) carry to memory every position step).
PAIR_BN = 32
PAIR_BH = 128


@functools.lru_cache(maxsize=128)
def _pair_block_call(
    tn: int, mi: int, rp: int, nbp: int, hbp: int, interpret: bool,
):
    """Pair-block kernel: (valt (tn,nbp)u32, mskt (tn,nbp)u32, ln (nbp,)i32,
    pht (rp,hbp)u32, lh (hbp,)i32) -> first (nbp,hbp)i32 in [0,mi],
    mi = no-match."""
    bn, bh = PAIR_BN, PAIR_BH

    def kernel(valt_ref, mskt_ref, ln_ref, pht_ref, lh_ref, out_ref):
        vb = [valt_ref[t, :][:, None] for t in range(tn)]
        mb = [mskt_ref[t, :][:, None] for t in range(tn)]

        def step(j, acc):
            # i runs DESCENDING, so a plain select keeps the smallest
            # matching i.  Validity (i <= limit) is a PREFIX of the range,
            # so the smallest raw match is valid iff <= limit: one filter
            # after the loop.
            i = mi - 1 - j
            m = None
            for t in range(tn):
                row = pht_ref[pl.ds(i + 4 * t, 1), :]  # (1, bh) windows
                eq = (row & mb[t]) == vb[t]  # values pre-masked (needle.py)
                m = eq if m is None else jnp.logical_and(m, eq)
            return jnp.where(m, i, acc)

        acc = jax.lax.fori_loop(
            0, mi, step, jnp.full((bn, bh), mi, jnp.int32)
        )
        limit = lh_ref[...][None, :] - ln_ref[...][:, None]
        out_ref[...] = jnp.where(acc <= limit, acc, jnp.int32(mi))

    return pl.pallas_call(
        kernel,
        grid=(nbp // bn, hbp // bh),
        in_specs=[
            pl.BlockSpec((tn, bn), lambda ni, hi: (0, ni)),
            pl.BlockSpec((tn, bn), lambda ni, hi: (0, ni)),
            pl.BlockSpec((bn,), lambda ni, hi: (ni,)),
            pl.BlockSpec((rp, bh), lambda ni, hi: (0, hi)),
            pl.BlockSpec((bh,), lambda ni, hi: (hi,)),
        ],
        out_specs=pl.BlockSpec((bn, bh), lambda ni, hi: (ni, hi)),
        out_shape=jax.ShapeDtypeStruct((nbp, hbp), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="sliceslice_pair_block",
    )


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pair_block_pallas(valt, mskt, ln, pht, lh, tn, mi, interpret):
    """Same contract as `_pair_block`, register-resident (jittable; padding
    fuses into the caller's program).  Padded needle columns get len 2**30
    (limit < 0: never valid); padded haystack columns get len -1 (same)."""
    nb = valt.shape[1]
    hb = pht.shape[1]
    nbp = _round_up(nb, PAIR_BN)
    hbp = _round_up(hb, PAIR_BH)
    rp = mi + 4 * tn - 3
    valp = jnp.pad(valt, ((0, 0), (0, nbp - nb)))
    mskp = jnp.pad(mskt, ((0, 0), (0, nbp - nb)))
    lnp = jnp.pad(ln, ((0, nbp - nb),), constant_values=1 << 30)
    phtp = jnp.pad(pht[:rp], ((0, 0), (0, hbp - hb)))
    lhp = jnp.pad(
        lh.astype(jnp.int32), ((0, hbp - hb),), constant_values=-1
    )
    call = _pair_block_call(tn, mi, rp, nbp, hbp, interpret)
    first = call(valp, mskp, lnp, phtp, lhp)[:nb, :hb]
    return first < mi, first


class PairwiseSearcher:
    """Preprocess a word list once; sweep needle x haystack blocks on device.

    ``contains_matrix(haystacks)``: bool[N, H]; ``first_matrix``: int32[N, H]
    with -1 for no match — exact ``find``-grade superset of the reference's
    bool sweep.
    """

    def __init__(
        self,
        needles: Sequence[bytes],
        block: int = BLOCK,
        use_pallas: bool = True,
    ):
        from ..needle import build_probe_table

        self.needles = [bytes(w) for w in needles]
        self.block = block
        # The Pallas block kernel by default (compiled on the GPU,
        # interpreted on the CPU: config.use_interpret); use_pallas=False
        # selects the portable XLA formulation, the differential reference.
        config.use_interpret()  # refuses an unsupported backend up front
        self.use_pallas = use_pallas
        self.jn = self._bucket(max_len(self.needles))
        self.tn = -(-self.jn // 4)
        vals, msks, lens = build_probe_table(self.needles, t_max=self.tn)
        self._valt = jnp.asarray(vals.T.copy())  # (tn, N) uint32
        self._mskt = jnp.asarray(msks.T.copy())
        self._ln = jnp.asarray(lens)
        self._hay_cache: dict = {}

    def _cache_get(self, kind: str, haystacks):
        # id()-keyed with a strong reference kept in the value, so a freed
        # list's address can never alias a new one.
        key = (kind, id(haystacks) if haystacks is not None else None)
        hit = self._hay_cache.get(key)
        if hit is not None and hit[0] is haystacks:
            return hit[1]
        return None

    #: retained (kind, haystack-list) cache entries; beyond this the oldest
    #: are evicted so a long-running service cycling through many distinct
    #: haystack lists doesn't pin every list + its (N, H) device matrices.
    _HAY_CACHE_CAP = 12

    def _cache_put(self, kind: str, haystacks, value):
        key = (kind, id(haystacks) if haystacks is not None else None)
        self._hay_cache.pop(key, None)
        self._hay_cache[key] = (haystacks, value)  # dicts keep insert order
        while len(self._hay_cache) > self._HAY_CACHE_CAP:
            self._hay_cache.pop(next(iter(self._hay_cache)))
        return value

    def _pack_hay(self, haystacks: Sequence[bytes] | None):
        hit = self._cache_get("pack", haystacks)
        if hit is not None:
            return hit
        hs = self.needles if haystacks is None else haystacks
        mi = self._bucket(max_len(hs))
        arr, lens = pack_words(hs, mi + 4 * self.tn)
        # Packed little-endian 4-byte windows per word, positions along
        # rows: pht[r, h] = window of word h at byte offset r.
        a = arr.T.astype(np.uint32)  # (W, H)
        pht = a[:-3] | (a[1:-2] << 8) | (a[2:-1] << 16) | (a[3:] << 24)
        out = (jnp.asarray(pht), jnp.asarray(lens), mi)
        return self._cache_put("pack", haystacks, out)

    @staticmethod
    def _bucket(x: int) -> int:
        for b in (2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256):
            if x <= b:
                return b
        return -(-x // 64) * 64

    def _plan(self, haystacks=None):
        """Static block plan: (i0, j0, jn_b, mi_b) per evaluated block pair.
        When word lists are length-sorted (the reference sorts its sweep the
        same way, tests/i386.rs:49), each block's max length is far below the
        global max: kernel shapes are bucketed per block pair, and
        needle-blocks whose shortest needle exceeds the haystack-block's
        longest word are skipped outright (all-false / no-match)."""
        pht, lh, mi = self._pack_hay(haystacks)
        hit = self._cache_get("plan", haystacks)
        if hit is not None:
            return hit
        ln_np = np.asarray(self._ln)
        lh_np = np.asarray(lh)
        n, h = self._valt.shape[1], pht.shape[1]
        b = self.block
        plan = []
        for i0 in range(0, n, b):
            ln_blk = ln_np[i0 : i0 + b]
            tn_b = -(-self._bucket(max(int(ln_blk.max()), 1)) // 4)
            for j0 in range(0, h, b):
                lh_blk = lh_np[j0 : j0 + b]
                if int(ln_blk.min()) > int(lh_blk.max()):
                    plan.append((i0, j0, 0, 0))  # skipped
                    continue
                mi_b = self._bucket(max(int(lh_blk.max()), 1))
                plan.append((i0, j0, tn_b, mi_b))
        out = (tuple(plan), pht, lh, mi, n, h)
        return self._cache_put("plan", haystacks, out)

    def _fused(self, plan, n: int, h: int, want: str):
        """One jit program for the whole sweep: every block kernel plus the
        requested reduction — host dispatch independent of block count.
        Cached at module level keyed on the (hashable) plan so searcher
        instances are NOT pinned alive by the compile cache (an instance-
        method lru_cache would leak every searcher's device tables in a
        long-running serving process)."""
        return _fused_runner(
            plan, n, h, want, self.block, self.use_pallas,
            config.use_interpret(),
        )

    def _matrices_device(self, haystacks=None):
        hit = self._cache_get("mat", haystacks)
        if hit is not None:
            return hit
        plan, pht, lh, _mi, n, h = self._plan(haystacks)
        run = self._fused(plan, n, h, "matrices")
        out = run(self._valt, self._mskt, self._ln, pht, lh)
        return self._cache_put("mat", haystacks, out)

    def contains_matrix(self, haystacks=None) -> np.ndarray:
        return np.asarray(self._matrices_device(haystacks)[0])

    def first_matrix(self, haystacks=None) -> np.ndarray:
        return np.asarray(self._matrices_device(haystacks)[1])

    def count_matches_device(self, haystacks=None):
        """Total match count across all pairs, device-resident (the bench
        checksum: forces full evaluation, fetches one scalar)."""
        plan, pht, lh, _mi, n, h = self._plan(haystacks)
        run = self._fused(plan, n, h, "count")
        return run(self._valt, self._mskt, self._ln, pht, lh)


@functools.lru_cache(maxsize=32)
def _fused_runner(
    plan, n: int, h: int, want: str, b: int, use_pallas: bool,
    interpret: bool,
):
    """The fused sweep program for one (plan, shape, reduction) — see
    PairwiseSearcher._fused."""
    if use_pallas:
        block_fn = functools.partial(_pair_block_pallas, interpret=interpret)
    else:
        block_fn = _pair_block

    def blocks(valt, mskt, ln, pht, lh):
        for (i0, j0, tn_b, mi_b) in plan:
            if tn_b == 0:
                yield (i0, j0, 0), None
                continue
            yield (i0, j0, mi_b), block_fn(
                valt[:tn_b, i0 : i0 + b],
                mskt[:tn_b, i0 : i0 + b],
                ln[i0 : i0 + b],
                pht[: mi_b + 4 * tn_b - 3, j0 : j0 + b],
                lh[j0 : j0 + b],
                tn_b,
                mi_b,
            )

    if want == "count":

        @jax.jit
        def run(valt, mskt, ln, pht, lh):
            total = jnp.int32(0)
            for _meta, res in blocks(valt, mskt, ln, pht, lh):
                if res is not None:
                    total = total + jnp.sum(res[0], dtype=jnp.int32)
            return total

    else:

        @jax.jit
        def run(valt, mskt, ln, pht, lh):
            contains = jnp.zeros((n, h), jnp.bool_)
            first = jnp.full((n, h), -1, jnp.int32)
            for (i0, j0, mi_b), res in blocks(valt, mskt, ln, pht, lh):
                if res is None:
                    continue
                c, f = res
                f = jnp.where(f >= mi_b, -1, f)
                contains = jax.lax.dynamic_update_slice(
                    contains, c, (i0, j0)
                )
                first = jax.lax.dynamic_update_slice(first, f, (i0, j0))
            return contains, first

    return run


def pairwise_contains_all(words: Sequence[bytes]) -> np.ndarray:
    """bool[N, N] containment matrix of a word list against itself (the
    reference short-haystack sweep shape)."""
    return PairwiseSearcher(words).contains_matrix()
