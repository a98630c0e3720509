"""Checkpoint files: one save and one restore for any tree of tensors.

Port of the JAX package's `checkpoint.py` (`ckpt_save`, `ckpt_restore` and
the `.structure.json` manifest). The reference writes an orbax directory;
this port has no orbax, so the format is its own: the tree flattened to
`{keystr path: tensor}` (the `convert.py` form, with dict keys as
`['key']` and NamedTuple fields as `.field`, the strings
`jax.tree_util.keystr` gives), every tensor moved to the CPU, written with
`torch.save` into one file at `path`. It is read back with
`torch.load(..., weights_only=True)`: no pickled object is ever
executed, and nothing but torch is needed to read it.

Crash safety is the reference's. A save writes `path.tmp` and its
manifest, moves the previous save aside to `path.old`, renames the new one
into place, swaps the manifest in and only then removes the aside: a crash
at any point leaves a whole checkpoint at `path` or at `path.old`, never a
torn one, and a restore that finds no file at `path` reads the aside.

A restore checks the saved tree against the caller's template (a live
tree of the same structure) first, from the manifest and again from the
file itself, and raises ValueError naming every leaf that is missing,
unexpected or of another shape or dtype.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch


def _manifest_path(path: str) -> str:
    return path + ".structure.json"


def flatten_tree(tree, prefix: str = "") -> Dict[str, object]:
    """The array leaves of a tree of dicts, NamedTuples, tensors and numpy
    arrays, keyed by keystr path; None subtrees have no leaves."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out: Dict[str, object] = {}
        for key, value in tree.items():
            out.update(flatten_tree(value, f"{prefix}[{key!r}]"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(flatten_tree(getattr(tree, name), f"{prefix}.{name}"))
        return out
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return {prefix: tree}
    raise TypeError(f"checkpoint: leaf {prefix or '(root)'} is a {type(tree).__name__}, not a tensor or array")


def _dtype_name(leaf) -> str:
    """numpy's name for the leaf's dtype ("int32", "float32", "bool", ...)."""
    return str(leaf.dtype).replace("torch.", "")


def _manifest_entries(tree) -> Dict[str, list]:
    """keystr -> [shape, dtype] for every leaf."""
    return {key: [list(leaf.shape), _dtype_name(leaf)] for key, leaf in flatten_tree(tree).items()}


def _as_cpu_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf.detach().to("cpu").contiguous()


def ckpt_save(path: str, payload) -> None:
    """Save a tree of tensors to the file `path` (overwrites), atomically
    (module note)."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp"
    flat = {key: _as_cpu_tensor(leaf) for key, leaf in flatten_tree(payload).items()}
    torch.save(flat, tmp)
    manifest_tmp = _manifest_path(tmp)
    with open(manifest_tmp, "w") as fh:
        json.dump(_manifest_entries(payload), fh)
    # Never destroy the only whole checkpoint: the previous save goes aside
    # (a rename), the new one moves into place, then the aside goes.
    old = f"{path}.old"
    if os.path.exists(old):
        os.remove(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    os.replace(manifest_tmp, _manifest_path(path))
    if os.path.exists(old):
        os.remove(old)


def _mismatches(saved: Dict[str, list], expected: Dict[str, list]) -> list:
    problems = []
    for key, spec in expected.items():
        got = saved.get(key)
        if got is None:
            problems.append(f"missing in checkpoint: {key} {spec}")
        elif list(got) != list(spec):
            problems.append(
                f"mismatch at {key}: checkpoint has shape={got[0]} dtype={got[1]}, "
                f"template expects shape={spec[0]} dtype={spec[1]}"
            )
    for key in saved:
        if key not in expected:
            problems.append(f"unexpected leaf in checkpoint: {key}")
    return problems


def _raise_mismatch(path: str, problems: list) -> None:
    raise ValueError(
        f"checkpoint at {path!r} does not match the expected state structure (was it saved from a "
        "different config/trace or an older state layout?):\n  " + "\n  ".join(problems)
    )


def _rebuild(template, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """The template's structure with the saved leaves, each on its template
    leaf's device (numpy leaves come back as numpy arrays)."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {key: _rebuild(value, flat, f"{prefix}[{key!r}]") for key, value in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[_rebuild(getattr(template, f), flat, f"{prefix}.{f}") for f in template._fields])
    leaf = flat[prefix]
    if isinstance(template, np.ndarray):
        return leaf.numpy()
    return leaf.to(template.device)


def ckpt_restore(path: str, template):
    """The tree ckpt_save wrote at `path`, in the structure of `template`
    (shapes and dtypes checked against it; module note). Raises ValueError
    where there is no checkpoint or where it does not match."""
    path = os.path.abspath(path)
    manifest_path = _manifest_path(path)
    if not os.path.isfile(path):
        # A save that crashed between moving the previous checkpoint aside
        # and moving the new one into place leaves the only whole one at
        # the aside; its manifest is still at the main path (the manifest
        # swap comes last).
        aside = f"{path}.old"
        if not os.path.isfile(aside):
            raise ValueError(f"no checkpoint file at {path!r}")
        path = aside
    expected = _manifest_entries(template)
    if os.path.exists(manifest_path):
        with open(manifest_path) as fh:
            problems = _mismatches(json.load(fh), expected)
        if problems:
            _raise_mismatch(path, problems)
    try:
        flat = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as exc:  # torch raises several types for a bad file
        raise ValueError(f"failed to read checkpoint at {path!r}: {exc}") from exc
    if not isinstance(flat, dict) or not all(isinstance(v, torch.Tensor) for v in flat.values()):
        raise ValueError(f"checkpoint at {path!r} is not a flat dict of tensors")
    problems = _mismatches({k: [list(v.shape), _dtype_name(v)] for k, v in flat.items()}, expected)
    if problems:
        _raise_mismatch(path, problems)
    return _rebuild(template, flat)
