"""Parity of the port's host-side and step-level building blocks with the
JAX reference: the blocked cumsum, the time pairs, the stable queue rank,
the trace compiler and the initial state (dtypes included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import TraceSpec  # noqa: F401  (installs the F1 alias first)

from kubernetriks_tpu.batched import state as jax_state
from kubernetriks_tpu.batched import step as jax_step
from kubernetriks_tpu.batched import timerep as jax_timerep
from kubernetriks_tpu.batched import trace_compile as jax_tc
from kubernetriks_tpu.config import SimulationConfig as JaxConfig

from kubernetriks_tpu_torch.batched import state as port_state
from kubernetriks_tpu_torch.batched import step as port_step
from kubernetriks_tpu_torch.batched import timerep as port_timerep
from kubernetriks_tpu_torch.batched import trace_compile as port_tc
from kubernetriks_tpu_torch.config import SimulationConfig as PortConfig
from kubernetriks_tpu_torch.convert import state_from_numpy, state_to_numpy

from test_torch_reference import jax_state_to_numpy

DELAYS = """sim_name: t
seed: 1
scheduling_cycle_interval: 10.0
as_to_ps_network_delay: 0.050
ps_to_sched_network_delay: 0.010
sched_to_as_network_delay: 0.020
as_to_node_network_delay: 0.150
"""

CLUSTER_YAML = """events:
- timestamp: 0.0
  event_type:
    !CreateNode
      node:
        metadata: {name: n1}
        status: {capacity: {cpu: 8000, ram: 17179869184}}
- timestamp: 3.0
  event_type:
    !CreateNode
      node:
        metadata: {name: n0}
        status: {capacity: {cpu: 16000, ram: 34359738368}}
- timestamp: 50.0
  event_type:
    !RemoveNode
      node_name: n1
- timestamp: 60.0
  event_type:
    !CreateNode
      node:
        metadata: {name: n1}
        status: {capacity: {cpu: 4000, ram: 8589934592}}
"""

WORKLOAD_YAML = """events:
- timestamp: 1.5
  event_type:
    !CreatePod
      pod:
        metadata: {name: b}
        spec:
          resources:
            requests: {cpu: 1000, ram: 1000000}
            limits: {cpu: 1000, ram: 1000000}
          running_duration: 20.0
- timestamp: 1.5
  event_type:
    !CreatePod
      pod:
        metadata: {name: a}
        spec:
          resources:
            requests: {cpu: 3000, ram: 2097152}
            limits: {cpu: 3000, ram: 2097152}
- timestamp: 30.0
  event_type:
    !RemovePod
      pod_name: a
"""


@pytest.mark.parametrize("K", [1, 8, 16, 17, 64, 256, 257, 300, 512, 1024, 2048, 4096])
def test_xla_cumsum16_is_bitwise_jnp_cumsum(K):
    rng = np.random.default_rng(K)
    x = (
        rng.uniform(0.0, 1e-3, (64, K)) * rng.uniform(0.5, 4.0, (64, 1))
    ).astype(np.float32)
    x[0] = np.float32(2.56e-4)  # the megakernel's constant-row case
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    got = port_step.xla_cumsum16(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_time_pairs_match_reference():
    rng = np.random.default_rng(7)
    interval = 10.0
    t = np.concatenate([rng.uniform(0, 1e5, 500), [0.0, 9.999999, 10.0, 1e6, np.inf]])
    w_j, o_j = jax_timerep.from_f64_np(t, interval)
    w_p, o_p = port_timerep.from_f64_np(t, interval)
    np.testing.assert_array_equal(w_j, w_p)
    np.testing.assert_array_equal(o_j.view(np.int32), o_p.view(np.int32))
    win = rng.integers(0, 1000, 300).astype(np.int32)
    off = rng.uniform(0, 35.0, 300).astype(np.float32)
    want = jax.jit(lambda w, o: jax_timerep.t_norm(w, o, jnp.float32(interval)))(win, off)
    got = port_timerep.t_norm(
        torch.from_numpy(win), torch.from_numpy(off), torch.tensor(interval, dtype=torch.float32)
    )
    np.testing.assert_array_equal(np.asarray(want.win), got.win.numpy())
    np.testing.assert_array_equal(np.asarray(want.off).view(np.int32), got.off.numpy().view(np.int32))


def test_stable_queue_rank_matches_reference():
    rng = np.random.default_rng(11)
    C, P = 3, 40
    k1 = rng.choice(np.float32([0.0, 1.5, np.inf]), (C, P)).astype(np.float32)
    k2 = rng.integers(0, 3, (C, P)).astype(np.int32)
    k3 = rng.integers(0, 2, (C, P)).astype(np.int32)
    want = np.asarray(jax_step._stable_queue_rank((k1, k2, k3)))
    got = port_step._stable_queue_rank(tuple(torch.from_numpy(k) for k in (k1, k2, k3)))
    np.testing.assert_array_equal(want, got.numpy())


def _compiled_pair():
    spec = TraceSpec(cluster_yaml=CLUSTER_YAML, workload_yaml=WORKLOAD_YAML)
    jc, jw = spec.events("jax")
    pc, pw = spec.events("port")
    j = jax_tc.compile_cluster_trace(jc, jw, JaxConfig.from_yaml(DELAYS))
    p = port_tc.compile_cluster_trace(pc, pw, PortConfig.from_yaml(DELAYS))
    return j, p


def test_compile_cluster_trace_matches_reference():
    j, p = _compiled_pair()
    for name in ("ev_time", "ev_kind", "ev_slot", "node_cap_cpu", "node_cap_ram",
                 "pod_req_cpu", "pod_req_ram", "pod_duration"):
        a, b = getattr(j, name), getattr(p, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert j.node_names == p.node_names and j.pod_names == p.pod_names


def test_pad_and_batch_matches_reference():
    j, p = _compiled_pair()
    want = jax_tc.pad_and_batch([j, j], n_pods=128)
    got = port_tc.pad_and_batch([p, p], n_pods=128)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_init_state_leaves_and_dtypes_match_reference():
    rng = np.random.default_rng(2)
    C, N, P = 3, 5, 7
    cap_cpu = rng.integers(1, 64000, (C, N)).astype(np.int32)
    cap_ram = rng.integers(1, 131072, (C, N)).astype(np.int32)
    req_cpu = rng.integers(0, 4000, (C, P)).astype(np.int32)
    req_ram = rng.integers(0, 8192, (C, P)).astype(np.int32)
    dur = np.where(rng.random((C, P)) < 0.2, -1.0, rng.uniform(1, 500, (C, P)))
    want = jax_state_to_numpy(
        jax_state.init_state(C, N, P, cap_cpu, cap_ram, req_cpu, req_ram, dur, interval=10.0)
    )
    got = state_to_numpy(
        port_state.init_state(C, N, P, cap_cpu, cap_ram, req_cpu, req_ram, dur, interval=10.0, device="cpu")
    )
    assert list(want) == list(got)
    for key in want:
        assert want[key].dtype == got[key].dtype, key
    assert port_state.compare_states(want, got) == []
    # Round trip through the exchange format.
    back = state_to_numpy(state_from_numpy(want, "cpu"))
    assert port_state.compare_states(want, back) == []
    assert all(back[k].dtype == want[k].dtype for k in want)
