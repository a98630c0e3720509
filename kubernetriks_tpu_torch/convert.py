"""State carried across between the JAX engine and this port.

What carries over is the simulation state (both engines rebuild the
compiled trace slab from the same traces) and, for the RL loop, the policy
heads' weights (policy_params_from_flax, attention_params_from_jax). The
exchange format is framework-neutral — a flat dict of
numpy arrays keyed by attribute path (".pods.queue_ts.win"), the strings
`jax.tree_util.keystr` gives for the JAX engine's `ClusterBatchState` —
so this module needs neither jax nor the JAX package.

    flat = {keystr(p): np.asarray(x) for p, x in tree_flatten_with_path(jax_state)}
    port.install_state(state_from_numpy(flat, port.device), jax_sim.next_window_idx)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from kubernetriks_tpu_torch.batched.engine import resolve_device
from kubernetriks_tpu_torch.batched.state import ClusterBatchState, flatten, unflatten


def state_to_numpy(state: ClusterBatchState) -> Dict[str, np.ndarray]:
    """The port's state as {path: numpy array}, copied to the host (a
    copy on the CPU too: the engine's state is updated in place). Any
    tree of NamedTuples flattens the same way, so the autoscaler statics
    (".ca_slot_class", ".node_class_key", ...) compare with the JAX
    engine's under compare_states too."""
    return {k: v.detach().to("cpu", copy=True).numpy() for k, v in flatten(state).items()}


def state_from_numpy(flat: Dict[str, np.ndarray], device=None) -> ClusterBatchState:
    """{path: numpy array} -> the port's state on `device` (None means the
    CUDA card and raises without one; see engine.resolve_device). Every
    leaf keeps its numpy dtype; a missing or extra leaf raises. The
    autoscaler leaves (".auto.*") come across when the state has them,
    CA slot reclaim's (".auto.ca_alloc", ".auto.ca_total",
    ".auto.ca_reclaimed") among them."""
    dev = resolve_device(device)
    leaves = {k: torch.tensor(np.asarray(v), device=dev) for k, v in flat.items()}
    try:
        state = unflatten(ClusterBatchState, leaves)
    except KeyError as e:
        raise KeyError(f"state leaves differ: missing {e}") from None
    unexpected = sorted(set(flat) - set(flatten(state)))
    if unexpected:
        raise KeyError(f"state leaves differ: unexpected {unexpected}")
    return state


def policy_params_from_flax(params, device=None) -> Dict[str, torch.Tensor]:
    """A flax SchedulerPolicy tree ({"params": {"Dense_0": {"kernel",
    "bias"}, ...}}, numpy arrays or anything np.asarray takes) as the
    params dict of rl/policy.SchedulerPolicy on `device`: all Dense layers
    but the last three are the trunk, then the logit layer, then the two
    value layers (flax's creation order); each kernel, (in, out) in flax,
    is transposed to the module's (out, in)."""
    dev = resolve_device(device)
    dense = params["params"] if "params" in params else params
    layers = len(dense) - 3
    names = [f"trunk.{i}" for i in range(layers)] + ["logit", "value1", "value2"]
    if layers < 1 or sorted(dense) != sorted(f"Dense_{i}" for i in range(len(names))):
        raise KeyError(f"expected Dense_0..Dense_k with k >= 3, got {sorted(dense)}")
    out = {}
    for i, name in enumerate(names):
        layer = dense[f"Dense_{i}"]
        kernel = np.asarray(layer["kernel"], np.float32)
        out[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(kernel.T), device=dev)
        out[f"{name}.bias"] = torch.tensor(np.asarray(layer["bias"], np.float32), device=dev)
    return out


def attention_params_from_jax(params, device=None) -> Dict[str, torch.Tensor]:
    """The attention head's parameter dict (rl/attention_policy names and
    layout, the reference's own) as float32 tensors on `device`."""
    dev = resolve_device(device)
    return {name: torch.tensor(np.asarray(value, np.float32), device=dev) for name, value in params.items()}
