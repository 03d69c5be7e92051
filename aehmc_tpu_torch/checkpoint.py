"""Checkpoint / resume of sampler state (port of :mod:`aehmc_tpu.checkpoint`).

A checkpoint is one ``.npz`` file of a flattened tree: tuples, lists,
dicts and NamedTuples (the port's states, :class:`~aehmc_tpu_torch.keys.Key`)
holding tensors, Python ints, floats, bools and strings, ``None`` and
``torch.Generator`` states (``get_state()`` bytes).  Every value keeps its
bits: bfloat16 is stored as its 16-bit pattern with a dtype tag, since
numpy has no bfloat16.  The file also records the tree's structure and each
leaf's device, so :func:`restore` can rebuild the tree without an example.
It is written to ``<path>.tmp`` and moved into place with ``os.replace``.

The JAX package's Orbax branch (a directory path) has no counterpart here
(ROADMAP.md item 1.13): any path that does not end in ``.npz`` raises
``NotImplementedError``.

Typical use::

    save(path, {"state": chain_state, "key": key, "step": i})
    restored = restore(path, {"state": chain_state, "key": key, "step": 0})
"""

import importlib
import json
import os
from typing import Any, List

import numpy as np
import torch

_PACKAGE = "aehmc_tpu_torch"


def _require_npz(path: str) -> None:
    if not path.endswith(".npz"):
        raise NotImplementedError(
            "only .npz checkpoints are ported; the JAX package's Orbax "
            "directory checkpoints have no counterpart (ROADMAP.md item "
            f"1.13), got {path!r}"
        )


def _flatten(tree: Any, leaves: List[Any]):
    """The structure of ``tree`` as JSON-able nested lists; its leaves are
    appended to ``leaves`` in order."""
    if tree is None:
        return ["none"]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        return ["namedtuple", f"{cls.__module__}:{cls.__qualname__}",
                [_flatten(x, leaves) for x in tree]]
    if isinstance(tree, (tuple, list)):
        return [type(tree).__name__, [_flatten(x, leaves) for x in tree]]
    if isinstance(tree, dict):
        return ["dict", [[str(k), _flatten(v, leaves)]
                         for k, v in tree.items()]]
    leaves.append(tree)
    return ["leaf", len(leaves) - 1]


def _named_tuple_class(name: str):
    module, qualname = name.split(":")
    if module != _PACKAGE and not module.startswith(_PACKAGE + "."):
        raise ValueError(f"a checkpoint names a class outside {_PACKAGE}: "
                         f"{name!r}")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _unflatten(spec, leaves: List[Any]):
    kind = spec[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return leaves[spec[1]]
    if kind == "namedtuple":
        return _named_tuple_class(spec[1])(
            *(_unflatten(s, leaves) for s in spec[2]))
    if kind in ("tuple", "list"):
        items = [_unflatten(s, leaves) for s in spec[1]]
        return tuple(items) if kind == "tuple" else items
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in spec[1]}
    raise ValueError(f"unknown node {kind!r} in a checkpoint")


def _encode(leaf):
    """``(array, meta)`` of one leaf: meta is ``[kind, dtype, device]``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        dtype = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            array = t.view(torch.int16).numpy().view(np.uint16)
        else:
            array = t.numpy()
        return array, ["tensor", dtype, str(leaf.device)]
    if isinstance(leaf, torch.Generator):
        return (leaf.get_state().numpy(),
                ["generator", "uint8", str(leaf.device)])
    if isinstance(leaf, bool):
        return np.asarray(leaf), ["bool", "bool", "cpu"]
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int64), ["int", "int64", "cpu"]
    if isinstance(leaf, float):
        return np.asarray(leaf, dtype=np.float64), ["float", "float64", "cpu"]
    if isinstance(leaf, str):
        return np.asarray(leaf), ["str", "str", "cpu"]
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _decode(array: np.ndarray, meta, like=None):
    """A leaf from its stored array; ``like`` (the example's leaf) gives the
    device and dtype of a tensor and the device of a generator."""
    kind, dtype, device = meta
    if kind == "tensor":
        if dtype == "bfloat16":
            t = torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(array))
        if isinstance(like, torch.Tensor):
            return t.to(device=like.device, dtype=like.dtype)
        return t.to(device)
    if kind == "generator":
        if isinstance(like, torch.Generator):
            device = like.device
        gen = torch.Generator(device=device)
        gen.set_state(torch.from_numpy(np.array(array)))
        return gen
    if kind == "bool":
        return bool(array)
    if kind == "int":
        return int(array)
    if kind == "float":
        return float(array)
    return str(array)


def save(path: str, tree: Any) -> None:
    """Save ``tree`` to the ``.npz`` file ``path``, atomically."""
    _require_npz(path)
    leaves: List[Any] = []
    spec = _flatten(tree, leaves)
    arrays, metas = {}, []
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"], meta = _encode(leaf)
        metas.append(meta)
    arrays["__tree__"] = np.asarray(json.dumps([spec, metas]))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def restore(path: str, example: Any = None) -> Any:
    """Restore a tree saved by :func:`save`.

    With ``example`` the tree takes the example's structure, and each
    tensor leaf the example leaf's device and dtype (shapes are the saved
    ones); without it the saved structure and devices.
    """
    _require_npz(path)
    with np.load(path) as data:
        spec, metas = json.loads(str(data["__tree__"]))
        arrays = [data[f"leaf_{i}"] for i in range(len(metas))]
    if example is None:
        return _unflatten(spec, [_decode(a, m) for a, m in zip(arrays, metas)])
    like: List[Any] = []
    example_spec = _flatten(example, like)
    if len(like) != len(arrays):
        raise ValueError(
            f"{path} holds {len(arrays)} leaves, the example {len(like)}")
    return _unflatten(example_spec,
                      [_decode(a, m, x) for a, m, x in zip(arrays, metas, like)])
