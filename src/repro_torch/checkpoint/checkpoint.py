"""Tree checkpointing in the JAX package's on-disk format: one
``step_XXXXXXXX/`` directory a step holding ``arrays.npz`` and
``manifest.json``, written atomically through a temporary directory, with
resume and pruning.

A tree is nested dicts (keys in sorted order), tuples and lists whose
leaves are tensors or numpy arrays; a leaf's key is its path, the dict keys
and sequence indices joined by ``/``, as the reference names a pytree
leaf.  npz has no bf16, so a bf16 leaf is stored as f32 and the manifest
records its dtype.  The port's LM keeps one tensor a layer while the
reference stacks each pattern slot over its periods;
:func:`repro_torch.convert.lm_tree` gives the reference's stacked tree, so
a checkpoint written by either package resumes in the other
(``launch/train.py``).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Tree = Any


def _flatten_with_paths(tree: Tree, prefix: Tuple = ()) -> Dict[str, Any]:
    """{path key: leaf} in the reference's leaf order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten_with_paths(v, prefix + (i,)))
        return out
    return {"/".join(str(p) for p in prefix): tree}


def _unflatten(like: Tree, leaves: Dict[str, Any], prefix: Tuple = ()):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, prefix + (k,)) for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves, prefix + (i,))
                          for i, v in enumerate(like))
    return leaves["/".join(str(p) for p in prefix)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array npz stores, the dtype the manifest records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.to(torch.float32).numpy(), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def save(directory: str, step: int, tree: Tree,
         extra: Optional[Dict] = None) -> str:
    """Atomically write the checkpoint for ``step``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        arrays, dtypes = {}, {}
        for k, v in _flatten_with_paths(tree).items():
            arrays[k], dtypes[k] = _to_numpy(v)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays.keys()),
            "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "dtypes": dtypes,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(directory: str, like: Tree,
            step: Optional[int] = None) -> Tuple[Tree, int, Dict]:
    """Restore into the structure of ``like``: each leaf takes the shape
    (checked), dtype and device of ``like``'s leaf at its path (a numpy
    leaf gives a numpy array)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k, ref in _flatten_with_paths(like).items():
            if k not in data:
                raise KeyError(f"checkpoint missing leaf {k}")
            arr = data[k]
            if list(arr.shape) != list(ref.shape):
                raise ValueError(f"shape mismatch for {k}: ckpt {arr.shape} "
                                 f"vs {tuple(ref.shape)}")
            if isinstance(ref, torch.Tensor):
                leaves[k] = torch.from_numpy(np.array(arr)).to(
                    dtype=ref.dtype, device=ref.device)
            else:
                leaves[k] = np.asarray(arr, dtype=np.asarray(ref).dtype)
    return _unflatten(like, leaves), manifest["step"], \
        manifest.get("extra", {})


def prune(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
