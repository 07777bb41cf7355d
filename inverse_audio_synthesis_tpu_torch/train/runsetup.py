"""Run setup: deterministic batch-number splits (the "data pipeline").

The reference materializes 50M batch numbers in host RAM and random_split's them into
train/val/test Subsets wrapped in DataLoaders (reference: runsetup.py:28-48, sizes:
ntest reserved first, then 90/10 of the remainder). Data itself is synthesized
on-device from the batch number, so the *only* job of the pipeline is to map a step
index to a batch number, deterministically and without replacement.

Here: a stateless format-preserving permutation (4-round Feistel
with cycle-walking) over [0, num_batches). O(1) memory instead of a 50M-element
permutation tensor; same semantics — random disjoint subsets, pseudorandom iteration
order, fully determined by the seed.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterator

from inverse_audio_synthesis_tpu_torch.parallel.launch import is_main_process


def _round_key(seed: int, rnd: int) -> int:
    h = hashlib.sha256(f"{seed}:{rnd}".encode()).digest()
    return int.from_bytes(h[:8], "little")


class FeistelPermutation:
    """Bijection on [0, n) via a balanced Feistel network + cycle walking."""

    def __init__(self, n: int, seed: int, rounds: int = 4):
        assert n >= 1
        self.n = n
        bits = max(2, (n - 1).bit_length())
        self.half_bits = (bits + 1) // 2
        self.mask = (1 << self.half_bits) - 1
        self.domain = 1 << (2 * self.half_bits)
        self.keys = [_round_key(seed, r) for r in range(rounds)]

    def _feistel(self, x: int) -> int:
        left, right = x >> self.half_bits, x & self.mask
        for key in self.keys:
            # splitmix64-style round function (explicit, version-stable)
            z = (right ^ key) * 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF
            z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
            f = (z ^ (z >> 31)) & self.mask
            left, right = right, left ^ f
        return (left << self.half_bits) | right

    def __call__(self, i: int) -> int:
        assert 0 <= i < self.n
        x = i
        while True:  # cycle walk until we land back inside [0, n)
            x = self._feistel(x)
            if x < self.n:
                return x


@dataclass(frozen=True)
class SplitSizes:
    train: int
    val: int
    test: int


class BatchNumberSplit:
    """Disjoint deterministic train/val/test batch-number streams."""

    def __init__(self, num_batches: int, ntest_batches: int, seed: int):
        # size arithmetic mirrors reference runsetup.py:32-36
        ntrain = int((num_batches - ntest_batches) * 0.9)
        nval = num_batches - ntrain - ntest_batches
        self.sizes = SplitSizes(ntrain, nval, ntest_batches)
        self.perm = FeistelPermutation(num_batches, seed)

    def train_batch_num(self, i: int) -> int:
        assert 0 <= i < self.sizes.train
        return self.perm(i)

    def val_batch_num(self, i: int) -> int:
        assert 0 <= i < self.sizes.val
        return self.perm(self.sizes.train + i)

    def test_batch_num(self, i: int) -> int:
        assert 0 <= i < self.sizes.test
        return self.perm(self.sizes.train + self.sizes.val + i)

    def train_iter(self, start: int = 0) -> Iterator[int]:
        for i in range(start, self.sizes.train):
            yield self.train_batch_num(i)


def runsetup(cfg) -> BatchNumberSplit:
    """Build the split from the composed config (reference surface: runsetup.py:16);
    rank 0 alone prints the config. Every rank draws the same batch numbers."""
    if is_main_process():
        print(cfg.to_yaml())
    return BatchNumberSplit(cfg.num_batches, cfg.ntest_batches, cfg.seed)
