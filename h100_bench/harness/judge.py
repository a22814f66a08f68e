"""What decides `correct`: the words the timed path delivered, on units
drawn from the seed, against the plain reference.

Units are sampled with a reservoir while the window runs, so every
delivered unit is equally likely to be compared whatever the window's
length, at the cost of a copy of the few units kept.  Once the window
has closed the reference recomputes each kept block from the generated
files, and two numbers are compared with their limits:

  mismatch_frac   int16 components that differ / components compared
  max_err         the largest |program - reference| over them
"""

from __future__ import annotations

import numpy as np

# Limits, each between the two readings it was set from (PERF.md, "What
# decides correct"): the largest the program gave over sound runs on the
# card (mismatch_frac 2.1e-7, max_err 6: the kernel's u32 carrier-phase
# floor) and the smallest the float32 control gave (0.028, 1,156).
LIMITS = {"mismatch_frac": 1e-4, "max_err": 100}


class Reservoir:
    """k items drawn uniformly from everything offered (algorithm R),
    with the draws for a batch of offers made in one call."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen = int(k), rng, 0
        self.items: dict = {}          # slot -> (key, data)

    def offer(self, keys: list, copy) -> None:
        """Offer items keys[i]; copy(i) makes the kept copy of item i."""
        n = len(keys)
        if n == 0:
            return
        highs = self.seen + 1 + np.arange(n)
        draws = self.rng.integers(0, highs)
        for i in range(n):
            slot = len(self.items) if len(self.items) < self.k \
                else int(draws[i])
            if slot < self.k:
                self.items[slot] = (keys[i], copy(i))
        self.seen += n

    def kept(self) -> list:
        return [self.items[s] for s in sorted(self.items)]


def iq_of_words(words: np.ndarray) -> np.ndarray:
    """Packed little-endian words (I & 0xffff) | (Q << 16) -> int16 [N, 2]."""
    return np.ascontiguousarray(words).view(np.int16).reshape(-1, 2)


def compare(got: dict, want: dict) -> dict:
    """Readings over the blocks in both: {key: int16 [N, 2]}."""
    bad = total = worst = 0
    failed = 0
    for key, g in got.items():
        w = want[key]
        d = np.abs(g.astype(np.int32) - w.astype(np.int32))
        n_bad = int(np.count_nonzero(d))
        bad += n_bad
        total += d.size
        worst = max(worst, int(d.max(initial=0)))
        failed += int(d.max(initial=0) > LIMITS["max_err"])
    return {"blocks": len(got), "components": total, "mismatches": bad,
            "mismatch_frac": bad / total if total else float("nan"),
            "max_err": worst, "failed_blocks": failed}


def verdict(readings: dict) -> tuple[bool, dict]:
    """(correct, the checks as printed: each number beside its limit)."""
    checks = {name: {"value": readings[name], "limit": lim}
              for name, lim in LIMITS.items()}
    ok = readings["blocks"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    checks["blocks"] = {"value": readings["blocks"], "limit": 1}
    return ok, checks
