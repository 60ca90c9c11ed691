"""Training driver.

Trains an assigned architecture (a reduced variant by default, ``--preset
full`` at its published widths and depth) on the synthetic Markov token
stream with AdamW, a cosine schedule, checkpointing and logging, on the
card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 30 [--device cpu]

The step is eager PyTorch: the loss (``Model.loss``, remat per pattern
period), its gradients by ``torch.autograd``, and the optimizer's update
(``repro_torch.optim``), whose new values are copied into the params.  No
kernel runs in the backward pass: attention under autograd takes the
chunked softmax, as the JAX package's training does
(``models/attention.py``).  Checkpoints are the JAX package's format and
layout (``repro_torch.checkpoint``, ``convert.lm_tree``), so a run resumes
from either package's.  The reference's behaviour is kept, quirks
included: the warmup makes step 0's learning rate 0, and a resumed run
restarts the Markov stream from its seed.  Every architecture trains: an
audio-frontend arch (whisper-base) is fed zero frames (B, encoder_seq,
d_model), and an MoE arch's loss, logged, carries its load-balance aux
term.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_leaf, lm_tree
from repro_torch.data.pipeline import place
from repro_torch.data.tokens import MarkovTokens
from repro_torch.models import Model
from repro_torch.optim import adamw, cosine_schedule


def checkpoint_tree(params, opt_state: Dict, cfg):
    """``(params, opt_state)`` as the JAX package's checkpoint tree: the
    params and each moment in its stacked layout."""
    names = [n for n, _ in params.named_parameters()]
    return (lm_tree({n: p.detach() for n, p in params.named_parameters()},
                    cfg),
            {k: lm_tree(dict(zip(names, v)), cfg)
             for k, v in opt_state.items()})


def load_checkpoint_tree(tree, params, opt_state: Dict, cfg) -> Dict:
    """Copy a checkpoint tree into ``params`` (in place); returns the
    optimizer state it holds, one tensor a param in param order."""
    names = [n for n, _ in params.named_parameters()]
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(lm_leaf(tree[0], n, cfg))
    return {k: [lm_leaf(tree[1][k], n, cfg) for n in names]
            for k in opt_state}


def make_train_step(model: Model, params, opt, remat: bool = True):
    """``step(batch, step, opt_state) -> (loss, ce, opt_state)``: the loss
    and its gradients for ``params`` (which must require grad), the
    optimizer's update copied into them."""
    leaves = list(params.parameters())

    def train_step(b, step, opt_state):
        loss, mets = model.loss(params, b, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new, state = opt.update(grads, leaves, opt_state, step)
            for p, v in zip(leaves, new):
                p.copy_(v)
        return loss.detach(), mets["ce"].detach(), state
    return train_step


def train_loop(cfg, *, steps: int, batch: int, seq: int, lr: float,
               ckpt_dir=None, ckpt_every: int = 0, seed: int = 0,
               log_every: int = 10, device="cuda", remat: bool = True,
               step_s: Optional[List[float]] = None):
    """Train ``steps`` steps (from the newest checkpoint under
    ``ckpt_dir`` where there is one); returns (params, losses).  Params are
    drawn from a generator seeded with ``seed`` on ``device``.  Where
    ``step_s`` is a list, each step's wall seconds, up to its loss read
    back, are appended to it."""
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(model.device).manual_seed(seed))
    params.requires_grad_(True)
    leaves = list(params.parameters())
    opt = adamw(cosine_schedule(lr, max(steps // 20, 1), steps), b2=0.95,
                weight_decay=0.01)
    opt_state = opt.init(leaves)
    step0 = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        tree, step0, _ = restore(ckpt_dir,
                                 checkpoint_tree(params, opt_state, cfg))
        opt_state = load_checkpoint_tree(tree, params, opt_state, cfg)
        print(f"resumed from step {step0}")

    train_step = make_train_step(model, params, opt, remat)
    stream = MarkovTokens(cfg.vocab_size, seed=seed)
    losses = []
    t0 = time.time()
    for i, b in enumerate(stream.batches(batch, seq, steps - step0)):
        step = step0 + i
        ts = time.perf_counter()
        b = place(b, model.device)
        if cfg.frontend == "audio":
            b["frames"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                      device=model.device)
        loss, ce, opt_state = train_step(b, step, opt_state)
        losses.append(float(loss))
        if step_s is not None:
            step_s.append(time.perf_counter() - ts)
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d}  loss {float(loss):7.4f}  "
                  f"ce {float(ce):7.4f}  {dt:6.1f}s", flush=True)
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            save(ckpt_dir, step + 1, checkpoint_tree(params, opt_state, cfg))
    if ckpt_dir:
        save(ckpt_dir, steps, checkpoint_tree(params, opt_state, cfg))
    return params, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.preset == "smoke":
        cfg = reduced(cfg, n_layers=args.layers, d_model=args.d_model)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq}")
    _, losses = train_loop(cfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every, seed=args.seed,
                           device=args.device)
    print(f"first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean loss {np.mean(losses[-10:]):.4f}")


if __name__ == "__main__":
    main()
