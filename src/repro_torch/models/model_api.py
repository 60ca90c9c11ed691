"""Public model API: one entry point per architecture family.

``Model`` wraps init / loss / prefill / decode behind the JAX package's
interface, so a launcher does not branch on architecture family.  A model
runs on the card unless it is built with ``device="cpu"``; asking for the
card where there is none raises.  Decoder-only stacks are ported; an
encoder-decoder arch (whisper-base) raises :class:`NotImplementedError`.
The reference's ``input_specs`` and abstract params serve its compile-only
dry run, which is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device = field(default="cuda")

    def __post_init__(self):
        if self.cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{self.cfg.name}: encoder-decoder models (models/encdec.py) "
                "are not ported yet; ROADMAP.md lists them")
        object.__setattr__(self, "device", resolve_device(self.device))

    # ------------------------------------------------------------- params
    def init(self, gen: Optional[torch.Generator] = None, dtype=torch.float32
             ) -> transformer.Transformer:
        """Params drawn from ``gen`` (a generator on the model's device), or
        left uninitialized for weights that are loaded next."""
        return transformer.init_params(gen, self.cfg, dtype, self.device)

    # --------------------------------------------------------------- loss
    def loss(self, params, batch: Dict[str, torch.Tensor], *,
             remat: bool = True):
        """(loss, {"ce", "aux"}); gradients flow where ``params`` require
        them."""
        return transformer.loss_fn(params, batch, self.cfg, remat=remat)

    # ------------------------------------------------------------ serving
    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache_seq: Optional[int] = None):
        return transformer.prefill(params, batch["tokens"], self.cfg,
                                   cache_seq)

    def decode_step(self, params, tokens: torch.Tensor, caches, pos: int):
        return transformer.decode_step(params, tokens, caches, pos, self.cfg)

    def init_caches(self, batch: int, seq_len: int, dtype=torch.bfloat16):
        return transformer.init_caches(self.cfg, batch, seq_len, dtype,
                                       self.device)
