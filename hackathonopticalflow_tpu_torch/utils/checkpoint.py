"""Pipeline checkpoint / resume (port of
hackathonopticalflow_tpu/utils/checkpoint.py).

Named states (tensors, arrays and scalars in tuples, NamedTuples, lists and
dicts) serialize to one npz: `<name>__<i>` holds leaf i, `<name>__treedef`
the structure, written to a temporary file and renamed into place, so a
kill mid-save leaves the previous checkpoint intact. The layout is the JAX
package's; the structure string is the port's own, so files do not cross
between the two packages.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, leaves: list) -> str:
    """Appends tree's leaves to `leaves` (dict entries in key order) and
    returns its structure; None is an empty subtree, as in a pytree."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k!r}:{_flatten(tree[k], leaves)}" for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return f"{type(tree).__name__}(" + ",".join(
            f"{f}={_flatten(v, leaves)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ",".join(_flatten(v, leaves) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    leaves.append(tree)
    return "*"


def _unflatten(template: Any, leaves) -> Any:
    """template's structure with its leaves taken from the iterator
    `leaves` in _flatten's order."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    saved = next(leaves)
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(saved).to(template.device)
    return saved


def _host(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save_checkpoint(path: str, **states: Any) -> None:
    """Save named states (e.g. frame_idx=np.int64(7), prev_gray=array)."""
    payload: dict = {"__names": np.array(sorted(states.keys()), dtype=object)}
    for name, tree in states.items():
        leaves: list = []
        treedef = _flatten(tree, leaves)
        payload[f"{name}__treedef"] = np.frombuffer(treedef.encode(), dtype=np.uint8)
        for i, leaf in enumerate(leaves):
            payload[f"{name}__{i}"] = _host(leaf)
    tmp = path + ".tmp"
    np.savez(tmp, **payload, allow_pickle=True)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_checkpoint(path: str, templates: dict[str, Any]) -> dict[str, Any]:
    """Restore states with the structure of same-structure templates and
    the saved leaves' shapes and dtypes: a template's tensor leaf comes
    back as a tensor on its device, any other leaf as a numpy array. A
    template key the file lacks comes back as the template."""
    data = np.load(path, allow_pickle=True)
    out = {}
    for name, template in templates.items():
        if f"{name}__treedef" not in data:
            out[name] = template
            continue
        leaves: list = []
        treedef = _flatten(template, leaves)
        saved = bytes(data[f"{name}__treedef"].tobytes()).decode()
        if saved != treedef:
            raise ValueError(
                f"checkpoint structure mismatch for '{name}': saved {saved[:120]} vs template {treedef[:120]}"
            )
        out[name] = _unflatten(template, iter(data[f"{name}__{i}"] for i in range(len(leaves))))
    return out
