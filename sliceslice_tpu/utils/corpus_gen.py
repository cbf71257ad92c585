"""Seeded synthetic corpora for checks and benchmarks.

Lowercase filler (``a``..``z``, uniform) with needles planted at given
offsets, generated chunk by chunk so a stream larger than host memory never
has to exist whole.  Uppercase needles cannot occur in the filler, so their
only matches are the plants.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

CHUNK = 64 * 1024 * 1024

Plant = Tuple[int, bytes]


def filler(size: int, seed: int) -> np.ndarray:
    """``size`` uniform lowercase bytes (uint8) from ``seed``."""
    rng = np.random.default_rng(seed)
    return np.frombuffer(rng.bytes(size), np.uint8) % 26 + 97


def planted_chunks(
    total: int, plants: Sequence[Plant], seed: int = 0, chunk: int = CHUNK
) -> Iterator[bytes]:
    """The corpus as consecutive byte chunks: chunk ``i`` is seeded with
    ``(seed, i)``, then every plant (or slice of one straddling the chunk
    edge) is written over it."""
    for i, base in enumerate(range(0, total, chunk)):
        size = min(chunk, total - base)
        buf = filler(size, (seed, i))
        for off, nd in plants:
            a = np.frombuffer(nd, dtype=np.uint8)
            lo, hi = off, off + len(nd)
            s, e = max(lo, base), min(hi, base + size)
            if s < e:
                buf[s - base : e - base] = a[s - lo : e - lo]
        yield buf.tobytes()


def planted_corpus(
    total: int, plants: Sequence[Plant], seed: int = 0
) -> bytes:
    """The whole corpus of :func:`planted_chunks` as one bytes object."""
    return b"".join(planted_chunks(total, plants, seed))


def boundary_plants(total: int) -> list:
    """(offset, needle) plants at the offsets where int32 and uint32
    position arithmetic would break (2**31, 2**32), at both ends of the
    corpus, and one needle planted twice (first-occurrence semantics
    across distant windows) — those that fit in ``total`` bytes."""
    plants = [
        (1_000, b"ALPHA-NEEDLE-01!"),
        (2**31 - 8, b"STRADDLE-2GIB-XX"),
        (2**31 + 12_345, b"BETA-NEEDLE-002!"),
        (2**32 + 777, b"GAMMA-NEEDLE-03!"),
        (total - 20, b"OMEGA-NEEDLE-04!"),
        (2**31 + 9_999_999, b"DELTA-NEEDLE-05!"),
        (2**32 + 50_000_000, b"DELTA-NEEDLE-05!"),
    ]
    return [(o, n) for o, n in plants if o + len(n) <= total]


def first_offsets(plants: Sequence[Plant]) -> dict:
    """{needle: earliest planted offset} — the exact answer for needles that
    cannot occur in the filler."""
    out: dict = {}
    for off, nd in plants:
        out[nd] = min(out.get(nd, off), off)
    return out
