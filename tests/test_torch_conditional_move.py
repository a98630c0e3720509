"""The conditional move on the device (enable_unscheduled_pods_conditional_move:
step.conditional_wake, ops/window_kernel.conditional_wake_scan) on the CPU.

- On seeded windows that hold node-add and freed events together (parked
  pods of mixed sizes, some stale): the device path (conditional_wake)
  equals its host-loop twin (conditional_wake_exact) and the reference's
  `_conditional_wake_exact` exactly; the scans' CUDA algorithm, written
  out per cluster in Python (every valid event, every parked pod up to
  the last), equals the twin's bounded loops on the sorted operands.
- tests/test_torch_engine.py's conditional-move case (the node-removal
  trace, seed 5) through the window executor on the stubbed capture
  backend: 0 eager windows, no host read, equal to the uncaptured run bit
  for bit and to the JAX XLA path under compare_states (float32
  `.metrics.` accumulators to rtol 1e-6, atol 0); again with the razor
  on, whose gated tails leave their WakeEvents in the executor's buffers.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import DELAYS
from test_torch_engine import churn_trace
from test_torch_executor import assert_bitwise_equal, stub_graphs
from test_torch_reference import build_jax_engine, build_port_engine, jax_state_to_numpy

from kubernetriks_tpu.batched import step as jax_step  # noqa: E402
from kubernetriks_tpu.batched.timerep import TPair as JaxTPair  # noqa: E402

from kubernetriks_tpu_torch.batched import step
from kubernetriks_tpu_torch.batched.state import PHASE_QUEUED, PHASE_RUNNING, PHASE_UNSCHEDULABLE, compare_states
from kubernetriks_tpu_torch.batched.timerep import TPair
from kubernetriks_tpu_torch.convert import state_to_numpy

CM_CONFIG = DELAYS + "enable_unscheduled_pods_conditional_move: true\n"


def seeded_window(seed: int, C: int = 3, N: int = 4, P: int = 24):
    """numpy operands of one window's wakes: parked pods (about half the
    slots) of mixed sizes, a few stale, node-adds and freed pods at
    distinct rel times in every cluster."""
    rng = np.random.default_rng(seed)
    phase = rng.choice([PHASE_QUEUED, PHASE_UNSCHEDULABLE, PHASE_RUNNING], size=(C, P), p=[0.2, 0.5, 0.3])
    rel = rng.permutation(C * (N + P)).reshape(C, N + P).astype(np.float32) * 0.25
    node_mask = rng.random((C, N)) < 0.5
    node_mask[:, 0] = True
    freed_mask = (phase == PHASE_RUNNING) & (rng.random((C, P)) < 0.7)
    return {
        "phase": phase.astype(np.int32),
        "queue_win": rng.integers(0, 5, (C, P)).astype(np.int32),
        "queue_off": (rng.integers(0, 8, (C, P)) * 1.25).astype(np.float32),
        "queue_seq": rng.permutation(C * P).reshape(C, P).astype(np.int32),
        "req_cpu": rng.choice([500, 1000, 2000, 4000, 9000], size=(C, P)).astype(np.int32),
        "req_ram": rng.choice([1, 2, 4, 8], size=(C, P)).astype(np.int32),
        "cap_cpu": rng.choice([4000, 8000, 16000], size=(C, N)).astype(np.int32),
        "cap_ram": rng.choice([8, 16], size=(C, N)).astype(np.int32),
        "stale": (phase == PHASE_UNSCHEDULABLE) & (rng.random((C, P)) < 0.1),
        "node_mask": node_mask,
        "node_rel": np.where(node_mask, rel[:, :N], np.inf).astype(np.float32),
        "freed_mask": freed_mask,
        "freed_rel": np.where(freed_mask, rel[:, N:], np.inf).astype(np.float32),
    }


def _side(x, xp, tpair, wake_cls):
    t = torch.from_numpy if xp is torch else jnp.asarray
    state = types.SimpleNamespace(nodes=types.SimpleNamespace(cap_cpu=t(x["cap_cpu"]), cap_ram=t(x["cap_ram"])))
    pods = types.SimpleNamespace(
        phase=t(x["phase"]), queue_ts=tpair(t(x["queue_win"]), t(x["queue_off"])), queue_seq=t(x["queue_seq"]),
        req_cpu=t(x["req_cpu"]), req_ram=t(x["req_ram"]),
    )
    wake = wake_cls(t(x["node_mask"]), t(x["node_rel"]), t(x["freed_mask"]), t(x["freed_rel"]))
    return state, pods, t(x["stale"]), wake


def scan_oracle(o_valid, o_cpu, o_ram, s_valid, s_is_node, s_cpu, s_ram):
    """conditional_wake.cu's walk, a cluster at a time: every valid event in
    order over the parked pods up to the last valid one."""
    o_valid, o_cpu, o_ram = (np.asarray(a) for a in (o_valid, o_cpu, o_ram))
    s_valid, s_is_node, s_cpu, s_ram = (np.asarray(a) for a in (s_valid, s_is_node, s_cpu, s_ram))
    C, P = o_valid.shape
    moved = np.zeros((C, P), bool)
    for c in range(C):
        nu = int(np.nonzero(o_valid[c])[0].max()) + 1 if o_valid[c].any() else 0
        for e in range(s_valid.shape[1]):
            if not s_valid[c, e]:
                continue
            bc, br = int(s_cpu[c, e]), int(s_ram[c, e])
            for j in range(nu):
                if not o_valid[c, j] or moved[c, j]:
                    continue
                fits = o_cpu[c, j] <= bc and o_ram[c, j] <= br
                if fits:
                    bc -= int(o_cpu[c, j])
                    br -= int(o_ram[c, j])
                if (not fits) if s_is_node[c, e] else fits:
                    moved[c, j] = True
    return moved


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_scan_equals_twin_and_reference(seed):
    x = seeded_window(seed)
    state, pods, stale, wake = _side(x, torch, TPair, step.WakeEvents)
    assert bool(wake.node_mask.any()) and bool(wake.freed_mask.any())
    got = step.conditional_wake(state, pods, stale, wake)
    twin = step.conditional_wake_exact(state, pods, stale, wake)
    assert torch.equal(got, twin)
    want = jax_step._conditional_wake_exact(*_side(x, jnp, JaxTPair, jax_step.WakeEvents))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(got.any()) and not bool(got.all())
    _, parked, events = step._wake_scan_inputs(state, pods, stale, wake)
    np.testing.assert_array_equal(scan_oracle(*parked, *events), step.wake_scan_plain(*parked, *events).numpy())


@pytest.fixture(scope="module")
def reference_state():
    jx = build_jax_engine(CM_CONFIG, churn_trace(5), 4, 8, "xla")
    jx.step_until_time(600.0)
    return jax_state_to_numpy(jx.state)


@pytest.mark.parametrize("razor", [False, True])
def test_conditional_move_runs_on_graphs(reference_state, razor):
    def build():
        return build_port_engine(CM_CONFIG, churn_trace(5), 4, 8, window_razor=razor)

    plain = build()
    plain.step_until_time(600.0)
    sim = stub_graphs(build())
    assert sim.conditional_move
    captured = sim.precompile_pieces()
    assert captured == len(sim._executor.reachable_keys()) > 0
    sim.step_until_time(600.0)
    stats = sim.dispatch_stats
    assert stats["eager_windows"] == 0 and stats["graph_windows"] == sim.windows_run == 61
    assert stats["captures"] == captured and sim.host_syncs == 0
    assert_bitwise_equal(sim.state, plain.state)
    got = state_to_numpy(sim.state)
    assert compare_states(reference_state, got) == []
    assert (got[".pods.attempts"] > 1).any()
    if razor:
        assert sim._executor.backend.bodies[False] > 0
