"""Public model API: one entry point per architecture family.

``Model`` wraps init / loss / prefill / decode behind the JAX package's
interface, so a launcher does not branch on architecture family.  A model
runs on the card unless it is built with ``device="cpu"``; asking for the
card where there is none raises.  An encoder-decoder arch (whisper-base)
runs ``models/encdec.py``, every other arch ``models/transformer.py``; an
encoder-decoder batch also carries ``frames`` (B, encoder_seq, d_model).
The reference's ``input_specs`` and abstract params serve its compile-only
dry run, which is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device = field(default="cuda")

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    # ------------------------------------------------------------- params
    @property
    def _stack(self):
        return encdec if self.cfg.is_encoder_decoder else transformer

    def init(self, gen: Optional[torch.Generator] = None, dtype=torch.float32
             ):
        """Params drawn from ``gen`` (a generator on the model's device), or
        left uninitialized for weights that are loaded next: an
        :class:`~repro_torch.models.encdec.EncDec` or a
        :class:`~repro_torch.models.transformer.Transformer`."""
        return self._stack.init_params(gen, self.cfg, dtype, self.device)

    # --------------------------------------------------------------- loss
    def loss(self, params, batch: Dict[str, torch.Tensor], *,
             remat: bool = True):
        """(loss, {"ce", "aux"}); gradients flow where ``params`` require
        them."""
        return self._stack.loss_fn(params, batch, self.cfg, remat=remat)

    # ------------------------------------------------------------ serving
    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache_seq: Optional[int] = None):
        if self.cfg.is_encoder_decoder:
            return encdec.prefill(params, batch["frames"], batch["tokens"],
                                  self.cfg, cache_seq)
        return transformer.prefill(params, batch["tokens"], self.cfg,
                                   cache_seq)

    def decode_step(self, params, tokens: torch.Tensor, caches, pos: int):
        return self._stack.decode_step(params, tokens, caches, pos, self.cfg)

    def init_caches(self, batch: int, seq_len: int, dtype=torch.bfloat16):
        return self._stack.init_caches(self.cfg, batch, seq_len, dtype,
                                       self.device)
