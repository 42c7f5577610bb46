"""Host-side pure-Python MT19937 (std::mt19937-compatible).

Used only at construction time to derive per-env level_seed_rand_gen seeds
from the master seed (vecgame.cpp:349-363) — a tiny, sequential job that
does not belong on device.  A copy of ``procgen_tpu.utils.host_mt``.
"""

N = 624
M = 397
MATRIX_A = 0x9908B0DF
UPPER = 0x80000000
LOWER = 0x7FFFFFFF
MASK = 0xFFFFFFFF


class HostMT19937:
    def __init__(self, seed: int):
        self.mt = [0] * N
        self.mt[0] = seed & MASK
        for i in range(1, N):
            prev = self.mt[i - 1]
            self.mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & MASK
        self.pos = N

    def _twist(self):
        mt = self.mt
        for i in range(N):
            y = (mt[i] & UPPER) | (mt[(i + 1) % N] & LOWER)
            mt[i] = mt[(i + M) % N] ^ (y >> 1) ^ (MATRIX_A if y & 1 else 0)
        self.pos = 0

    def next_u32(self) -> int:
        if self.pos >= N:
            self._twist()
        y = self.mt[self.pos]
        self.pos += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680 & MASK
        y ^= (y << 15) & 0xEFC60000 & MASK
        y ^= y >> 18
        return y & MASK

    def randint_raw(self) -> int:
        """RandGen::randint() — the raw signed draw (randgen.cpp:90-93)."""
        v = self.next_u32()
        return v - (1 << 32) if v >= (1 << 31) else v

    def randint(self, low: int, high: int) -> int:
        return low + self.next_u32() % ((high - low) & MASK)
