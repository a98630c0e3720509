"""State carried across between the JAX engine and this port.

The simulator has no model weights: what carries over is the simulation
state (and the compiled trace slab, which both engines rebuild from the
same traces). The exchange format is framework-neutral — a flat dict of
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

