"""Serving launcher: batched prefill + decode loop against an assigned
architecture (reduced preset), on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --tokens 8 [--device cpu]

Every architecture of ``configs/`` runs: decoder stacks of attention,
Mamba2 and MoE layers, and the encoder-decoder (whisper-base), which is
fed zero frames (B, encoder_seq, d_model) here, as the JAX package's
launcher feeds it.  Prefill runs the ``flash_attention`` kernel on every
full causal attention layer (``models/attention.py``) and, in full mode,
on every encoder layer (``models/encdec.py``); decode is plain PyTorch.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.models import Model


def _pick(logits: torch.Tensor, vocab_size: int, temperature: float,
          gen: Optional[torch.Generator]) -> torch.Tensor:
    """(B, Vpad) logits -> (B, 1) int32 next tokens.  Both rules run over
    the padded vocab and clip to the last true id, as the reference does."""
    if temperature > 0:
        probs = torch.softmax(logits / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
    else:
        tok = torch.argmax(logits, dim=-1)
    return torch.clamp(tok, max=vocab_size - 1).to(torch.int32)[:, None]


def generate(model: Model, params, prompts: torch.Tensor, n_new: int,
             cache_len: int, frames: Optional[torch.Tensor] = None,
             temperature: float = 0.0,
             gen: Optional[torch.Generator] = None,
             step_logits: Optional[List[torch.Tensor]] = None
             ) -> torch.Tensor:
    """prompts: (B, T0) -> (B, T0 + n_new), greedy or, with
    ``temperature > 0``, sampled from ``gen`` (a generator on the model's
    device; it cannot give ``jax.random.categorical``'s draws).  An
    encoder-decoder model takes ``frames`` (B, encoder_seq, d_model).
    Where ``step_logits`` is a list, the prefill's logits and every decode
    step's are appended to it, n_new + 1 of (B, Vpad) f32."""
    cfg = model.cfg
    T0 = prompts.shape[1]
    batch = {"tokens": prompts.to(model.device, torch.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = frames.to(model.device)
    prompts = batch["tokens"]
    with torch.no_grad():
        logits, caches = model.prefill(params, batch, cache_seq=cache_len)
        out = [prompts]
        for i in range(n_new):
            if step_logits is not None:
                step_logits.append(logits)
            tok = _pick(logits, cfg.vocab_size, temperature, gen)
            out.append(tok)
            logits, caches = model.decode_step(params, tok, caches, T0 + i)
        if step_logits is not None:
            step_logits.append(logits)
    return torch.cat(out, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_arch(args.arch))
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator(model.device).manual_seed(1),
        device=model.device, dtype=torch.int32)
    frames = (torch.zeros((args.batch, cfg.encoder_seq, cfg.d_model),
                          device=model.device)
              if cfg.is_encoder_decoder else None)
    t0 = time.perf_counter()
    seqs = generate(model, params, prompts, args.tokens,
                    cache_len=args.prompt_len + args.tokens, frames=frames,
                    temperature=args.temperature,
                    gen=torch.Generator(model.device).manual_seed(2))
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    print(f"{cfg.name} on {model.device}: generated {args.batch}x"
          f"{args.tokens} tokens in {dt:.1f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s)")
    print("sample:", seqs[0, :32].tolist())


if __name__ == "__main__":
    main()
