"""Checkpointing: numpy-archive pytree serialization (no external deps).

The JAX package's on-disk layout: <dir>/<step>/arrays.npz (leaf_0,
leaf_1, ... in flattening order: dict keys sorted, lists and tuples in
order) + tree.json (the structure, the leaf count, the step and each
leaf's dtype). A bfloat16 leaf is stored as its uint16 bits with
"bfloat16" recorded. Works for params, optimizer state, or any tensor
pytree; `restore` checks every shape against a template and restores the
saved dtypes and shapes onto the template's devices.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.training import tree as tree_lib

# dtypes numpy cannot hold, stored as raw bits of the same width
_BITS = {torch.bfloat16: (torch.int16, np.uint16, "bfloat16")}
_BY_NAME = {name: (dt, np_bits) for dt, (_, np_bits, name) in _BITS.items()}


def _to_numpy(leaf) -> tuple:
    """(array to store, dtype name) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _BITS:
            int_dt, np_bits, name = _BITS[t.dtype]
            return t.view(int_dt).numpy().view(np_bits), name
        return t.numpy(), str(t.numpy().dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    path = Path(ckpt_dir) / str(step)
    path.mkdir(parents=True, exist_ok=True)
    flat = tree_lib.leaves(tree)
    arrays, dtypes = {}, {}
    for i, leaf in enumerate(flat):
        arrays[f"leaf_{i}"], dtypes[str(i)] = _to_numpy(leaf)
    np.savez(path / "arrays.npz", **arrays)
    (path / "tree.json").write_text(json.dumps({
        "treedef": tree_lib.structure(tree), "n_leaves": len(flat),
        "step": step, "dtypes": dtypes}))
    return str(path)


def _leaf(arr: np.ndarray, saved_dt: Optional[str], tpl) -> Any:
    if saved_dt in _BY_NAME:
        dt, np_bits = _BY_NAME[saved_dt]
        t = torch.from_numpy(arr.view(np_bits).view(np.int16).copy()).view(dt)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(tpl, torch.Tensor):
        return t.to(device=tpl.device, dtype=tpl.dtype)
    return t


def restore(ckpt_dir: str, step: Optional[int], template: Any) -> Any:
    base = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = base / str(step)
    data = np.load(path / "arrays.npz")
    meta = json.loads((path / "tree.json").read_text())
    dtypes = meta.get("dtypes", {})
    flat = tree_lib.leaves(template)
    if meta.get("n_leaves", len(flat)) != len(flat):
        raise ValueError(f"checkpoint holds {meta['n_leaves']} leaves, the "
                         f"template {len(flat)}")
    out = []
    for i, tpl in enumerate(flat):
        arr = data[f"leaf_{i}"]
        if hasattr(tpl, "shape") and tuple(arr.shape) != tuple(tpl.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                             f"template {tuple(tpl.shape)}")
        out.append(_leaf(arr, dtypes.get(str(i)), tpl))
    return tree_lib.unflatten(template, out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = [int(p.name) for p in base.iterdir() if p.name.isdigit()]
    return max(steps) if steps else None
