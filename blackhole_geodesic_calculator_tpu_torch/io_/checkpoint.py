"""Checkpoint and resume of a training run (PyTorch port of
io_/checkpoint.py).

``save_train_state`` writes (params, opt_state, step): ``torch.save`` of
``{"params", "opt_state", "step"}`` (in place of the JAX package's orbax
directory), or, for a path ending in ``.npz``, one compressed npz of the
leaves and a string of the tree's structure.  ``opt_state`` is a torch
optimizer, ``parallel.train.OptState``, or their ``state_dict()``; it is
stored as the state dict, and ``load_train_state`` returns that dict,
which ``optimizer.load_state_dict`` takes back: the run then continues bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def _state(opt_state):
    return (opt_state.state_dict() if hasattr(opt_state, "state_dict")
            else opt_state)


def _walk(tree, path=""):
    """(path, leaf) of every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k!r}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, tree


def _structure(tree) -> str:
    """The tree's keys and, per leaf, its shape (a tensor or array) or its
    type (a Python scalar, None)."""
    parts = []
    for path, leaf in _walk(tree):
        if isinstance(leaf, (torch.Tensor, np.ndarray)):
            parts.append(f"{path}:{tuple(leaf.shape)}")
        else:
            parts.append(f"{path}:{type(leaf).__name__}")
    return ";".join(parts)


def _rebuild(like, leaves):
    """``like`` with its leaves replaced, in order, by ``leaves`` (numpy
    arrays): tensors on the template's device and dtype, scalars of the
    template's type, None kept."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    if like is None:
        return None
    arr = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr, dtype=like.dtype, device=like.device)
    return type(like)(arr.item())


def save_train_state(path: str, params, opt_state, step: int) -> str:
    """Checkpoint a training state: torch.save, or npz for a ``.npz``
    path."""
    params = {k: v.detach() for k, v in params.items()}
    state = _state(opt_state)
    if str(path).endswith(".npz"):
        tree = (params, state)
        leaves = [np.asarray(leaf.detach().cpu().numpy()
                             if isinstance(leaf, torch.Tensor) else leaf)
                  for _, leaf in _walk(tree) if leaf is not None]
        np.savez_compressed(
            path, step=np.asarray(step),
            treedef=np.frombuffer(_structure(tree).encode(), np.uint8),
            **{f"leaf_{i}": v for i, v in enumerate(leaves)})
        return path
    torch.save({"params": params, "opt_state": state, "step": int(step)},
               path)
    return path


def load_train_state(path: str, like=None):
    """(params, opt_state, step), the opt_state a state dict.  For an npz
    checkpoint ``like`` must be a (params, opt_state) template of the same
    structure (a torch optimizer's state exists once it has stepped),
    whose devices and dtypes the restored tensors take; a template of
    another structure raises rather than mis-assigning leaves.  A
    torch.save checkpoint needs no template: its tensors come back where
    they were saved."""
    if str(path).endswith(".npz"):
        if like is None:
            raise ValueError("npz restore needs a `like` pytree template")
        tree = (like[0], _state(like[1]))
        with np.load(path) as z:
            step = int(z["step"])
            saved = bytes(z["treedef"]).decode()
            want = _structure(tree)
            if saved != want:
                raise ValueError(
                    "checkpoint treedef mismatch -- the `like` template has "
                    "a different pytree structure than what was saved "
                    "(leaves would be silently mis-assigned):\n"
                    f"  saved: {saved}\n  like:  {want}")
            n = sum(leaf is not None for _, leaf in _walk(tree))
            leaves = iter([z[f"leaf_{i}"] for i in range(n)])
        params, opt_state = _rebuild(tree, leaves)
        return params, opt_state, step
    ck = torch.load(path, weights_only=True)
    return ck["params"], ck["opt_state"], ck["step"]
