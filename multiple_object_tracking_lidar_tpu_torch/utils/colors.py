"""Deterministic track colors with exact glibc rand() parity.

The reference seeds the C library PRNG with 5323 and draws three rand()
values per new track for an RGBA marker color
(ref: src/multiple_object_tracking_lidar.cpp:75, 536-542).  To make our viz
output byte-comparable we reimplement glibc's TYPE_3 additive-feedback
generator (the documented algorithm behind rand()/random() on glibc).

Verified against gcc/glibc: first draws for seed 5323 are
1365506864, 1679522910, 1014739851, ...
"""

from __future__ import annotations

RAND_MAX = 2147483647


class GlibcRand:
    """glibc TYPE_3 random(): r[i] = (r[i-3] + r[i-31]) mod 2^32, out = r[i] >> 1."""

    def __init__(self, seed: int):
        seed = seed % 2147483647
        if seed == 0:
            seed = 1
        r = [0] * 34
        r[0] = seed
        for i in range(1, 31):
            # Schrage's method for (16807 * r[i-1]) % 2147483647 as in glibc initstate
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._buf = r
        # warm-up: glibc discards the first 310 outputs
        for _ in range(310):
            self._step()

    def _step(self) -> int:
        buf = self._buf
        v = (buf[-3] + buf[-31]) & 0xFFFFFFFF
        buf.append(v)
        # keep the sliding window bounded
        if len(buf) > 64:
            del buf[:-34]
        return v >> 1

    def rand(self) -> int:
        return self._step()

    def uniform(self) -> float:
        """(float)rand() / (float)RAND_MAX, as the reference computes colors."""
        import numpy as np

        return float(np.float32(np.float32(self.rand()) / np.float32(RAND_MAX)))


def make_colorset(n: int, seed: int = 5323) -> list[tuple[float, float, float, float]]:
    """First ``n`` track colors exactly as the reference generates them:
    r,g,b = rand()/RAND_MAX in registration order, alpha fixed 0.8
    (ref: cpp:537-542)."""
    g = GlibcRand(seed)
    out = []
    for _ in range(n):
        r_, g_, b_ = g.uniform(), g.uniform(), g.uniform()
        out.append((r_, g_, b_, 0.8))
    return out
