"""Public model API: one entry point per architecture family.

``Model`` wraps init / loss / prefill / decode behind the JAX package's
interface, so a launcher does not branch on architecture family.  A model
runs on the card unless it is built with ``device="cpu"``; asking for the
card where there is none raises.  An encoder-decoder arch (whisper-base)
runs ``models/encdec.py``, every other arch ``models/transformer.py``; an
encoder-decoder batch also carries ``frames`` (B, encoder_seq, d_model).
``input_specs``, ``Model.abstract_params`` and ``Model.abstract_caches``
give meta-tensor stand-ins for every input, param and cache (shapes and
dtypes, no allocation), which the dry run (``launch/dryrun.py``) lays out
on its mesh; ``concrete_inputs`` draws small real batches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
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

    def abstract_params(self, dtype=torch.bfloat16):
        """The params module on the meta device: every leaf's shape and
        dtype, nothing allocated (Jamba 398B builds in a second)."""
        return self._stack.init_params(None, self.cfg, dtype, META)

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

    def abstract_caches(self, batch: int, seq_len: int, dtype=torch.bfloat16):
        """:meth:`init_caches` on the meta device."""
        return self._stack.init_caches(self.cfg, batch, seq_len, dtype, META)


META = torch.device("meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig, device=META
                ) -> Dict[str, torch.Tensor]:
    """Stand-ins (meta tensors by default; ``device`` makes empty ones
    elsewhere, a fake mode's for the dry run) for every model input of
    this (arch x input-shape) combination.

    train   -> {tokens, labels} (+ frames for audio)
    prefill -> {tokens} (+ frames)
    decode  -> {tokens (B,1), pos scalar} (+ frames); caches come from
               Model.abstract_caches and are passed alongside.
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def tok(*s, dtype=i32):
        return torch.empty(s, dtype=dtype, device=device)
    specs: Dict[str, torch.Tensor] = {}
    if shape.mode == "train":
        specs["tokens"] = tok(B, S)
        specs["labels"] = tok(B, S)
    elif shape.mode == "prefill":
        specs["tokens"] = tok(B, S)
    else:  # decode: one new token against a seq_len cache
        specs["tokens"] = tok(B, 1)
        specs["pos"] = tok()
    if cfg.frontend == "audio":
        # stubbed conv frontend: precomputed frame embeddings
        specs["frames"] = tok(B, cfg.encoder_seq, cfg.d_model,
                              dtype=torch.bfloat16)
    return specs


def concrete_inputs(cfg: ArchConfig, shape: ShapeConfig,
                    gen: torch.Generator,
                    batch_override: Optional[int] = None,
                    seq_override: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """Small concrete batches drawn from ``gen``, on its device (reduced
    shapes): tokens uniform over the true vocab, frames standard normal
    rounded to bf16, and a decode's ``pos`` S // 2."""
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    dev = gen.device
    i32 = torch.int32

    def ids(*s):
        return torch.randint(0, cfg.vocab_size, s, generator=gen, dtype=i32,
                             device=dev)
    out: Dict[str, torch.Tensor] = {}
    if shape.mode == "train":
        out["tokens"] = ids(B, S)
        out["labels"] = ids(B, S)
    elif shape.mode == "prefill":
        out["tokens"] = ids(B, S)
    else:
        out["tokens"] = ids(B, 1)
        out["pos"] = torch.tensor(S // 2, dtype=i32, device=dev)
    if cfg.frontend == "audio":
        out["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                    generator=gen, dtype=torch.float32,
                                    device=dev).to(torch.bfloat16)
    return out
