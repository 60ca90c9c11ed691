"""Batch placement: host numpy batches onto the device.

The JAX package places a batch on its mesh with a ``NamedSharding`` over
the batch axes (``batch_sharding``).  On one card there is nothing to
split, so ``batch_sharding`` has no counterpart here: a batch goes whole
to ``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


def place(batch: Dict[str, np.ndarray], device="cuda"
          ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in batch.items()}


def sharded_iterator(it: Iterator[Dict[str, np.ndarray]], device="cuda"
                     ) -> Iterator[Dict[str, torch.Tensor]]:
    for b in it:
        yield place(b, device)
