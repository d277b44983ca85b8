"""Fault-tolerant checkpointing in the reference's on-disk format, the port
of ``repro.train.checkpoint``: a checkpoint written by either package is
restored by the other.

  * step-tagged directories (``step_0000000010``), written to a temp name
    and atomically renamed: a crash mid-write never corrupts the latest
    checkpoint;
  * a manifest (``manifest.json``: leaf paths, shapes, dtypes, per-leaf
    sha1 of the logical bytes) detects partial checkpoints, which
    ``latest_step`` skips;
  * one ``.npy`` a leaf, named ``sha1(path)[:16]``, with the reference's
    leaf paths and stacked ``[L, ...]`` shapes (``params/blocks/attn/wq``,
    ``opt/.mu/blocks/attn/wq``, ``opt/.step``): ``save`` stacks the
    port's per-layer trees, ``restore`` splits them again; bfloat16 is
    stored as its raw ``uint16`` bits with the logical dtype
    ``"bfloat16"``;
  * keep-last-k garbage collection.

Trees are dicts (keys in sorted order, as ``jax.tree`` flattens them),
``NamedTuple``s (``AdamWState``: ``.step``, ``.mu``, ``.nu``), ``Params``
and tensor or numpy leaves (bfloat16 numpy leaves as in
``models/convert.py: to_numpy``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.convert import (params_from_stacked, stacked,
                                        to_numpy)
from repro_torch.models.model import Params, stacked_shapes


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaf_paths(tree: Any, prefix=()):
    """(path, leaf) in the reference's flatten order and key spelling."""
    if isinstance(tree, Params):
        tree = stacked(tree)
    if _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _leaf_paths(v, prefix + ("." + name,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _stored(leaf):
    """(array to store, logical dtype name) of a tensor or numpy leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        store = arr.view(np.uint16 if arr.dtype.itemsize == 2 else np.uint8)
        return store, ("bfloat16" if arr.dtype.itemsize == 2
                       else str(arr.dtype))
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {}
    for key, leaf in _leaf_paths(tree):
        store, logical = _stored(leaf)
        fn = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
        np.save(os.path.join(tmp, fn), store)
        manifest[key] = {
            "file": fn, "shape": list(store.shape), "dtype": logical,
            "sha1": hashlib.sha1(store.tobytes()).hexdigest(),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _is_valid(path: str) -> bool:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return False
    try:
        with open(mf) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    return all(os.path.exists(os.path.join(path, meta["file"]))
               for meta in manifest["leaves"].values())


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in reversed(steps):  # newest valid one wins
        if _is_valid(os.path.join(ckpt_dir, d)):
            return int(d.split("_")[1])
    return None


def _load(path: str, key: str, meta: Dict, verify: bool) -> torch.Tensor:
    arr = np.load(os.path.join(path, meta["file"]))
    if verify and hashlib.sha1(arr.tobytes()).hexdigest() != meta["sha1"]:
        raise ValueError(f"checksum mismatch for {key}")
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like: Any, verify: bool = False
            ) -> Any:
    """Load into the structure of ``like``: a ``Params`` leaf comes back as
    a ``Params`` on the device of ``like``'s, a tensor leaf on its
    tensor's device, a numpy leaf as numpy.  ``verify`` checks every
    leaf's sha1 against the manifest."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    load = lambda key: _load(path, key, leaves[key], verify)

    def build(node, prefix):
        if isinstance(node, Params):
            tree: Dict[str, Any] = {}
            for sub in stacked_shapes(node):
                *parents, name = sub.split("/")
                d = tree
                for p in parents:
                    d = d.setdefault(p, {})
                d[name] = load("/".join(prefix + (sub,)))
            return params_from_stacked(tree, next(node.parameters()).device)
        if _is_namedtuple(node):
            return type(node)(*(build(v, prefix + ("." + name,))
                                for name, v in zip(node._fields, node)))
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        t = load("/".join(prefix))
        if isinstance(node, torch.Tensor):
            return t.to(node.device)
        return to_numpy(t)
    return build(like, ())
