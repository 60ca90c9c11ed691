"""Synthetic token pipeline for LM training.

A first-order Markov token stream with a low-entropy transition structure,
so a model that trains correctly shows a clearly decreasing loss (unlike
uniform-random tokens, whose loss floor is log V).  Plain numpy, the JAX
package's draws in its order, so a seed gives the same stream bit for bit
in both packages; :mod:`repro_torch.data.pipeline` moves batches to the
card.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class MarkovTokens:
    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        rng = np.random.RandomState(seed)
        self.vocab = vocab
        # each token transitions to one of `branching` successors
        self.next_tokens = rng.randint(0, vocab, size=(vocab, branching))
        self.rng = rng

    def stream(self, n: int) -> np.ndarray:
        out = np.empty(n + 1, np.int32)
        out[0] = self.rng.randint(self.vocab)
        choices = self.rng.randint(0, self.next_tokens.shape[1], size=n)
        for i in range(n):
            out[i + 1] = self.next_tokens[out[i], choices[i]]
        return out

    def batches(self, batch: int, seq: int, n_steps: int
                ) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(n_steps):
            toks = np.stack([self.stream(seq) for _ in range(batch)])
            yield {"tokens": toks[:, :-1].astype(np.int32),
                   "labels": toks[:, 1:].astype(np.int32)}


def lm_batches(vocab: int, batch: int, seq: int, n_steps: int,
               seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    return MarkovTokens(vocab, seed).batches(batch, seq, n_steps)
