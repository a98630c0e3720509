"""Kernel-level parity: each of the port's three scheduling kernels (plain
PyTorch version on the CPU) against the JAX package's Pallas kernel in
interpret mode, on seeded inputs at small C, N, P, K (the two CA kernels'
parity is in test_torch_autoscale.py).

Tolerance: every output exactly equal, except the estimator stats rows
(count/total/total_sq/min/max), held to rtol 1e-6 — the compare_states
policy for float32 metric accumulators. Inputs carry ties in node scores
and queue keys (broken by queue seq, unique per pod as in real states),
lanes with no eligible pod, and event slots out of range (generators in
test_torch_cuda.py). The CUDA kernels are held against these plain
versions on the card by chip_smoke.py and test_torch_cuda.py.
"""

import numpy as np
import pytest

from test_torch_cuda import ca_down_inputs, ca_up_inputs, event_inputs, free_inputs, megakernel_inputs, t as _t
from test_torch_reference import jax_kernels

from kubernetriks_tpu_torch.ops import autoscale_kernel as ca_kernels
from kubernetriks_tpu_torch.ops import scheduler_kernel as port_kernels

SEEDS = [0, 1, 2]


def _assert_outputs(port_outs, jax_outs, stats_idx=None):
    assert len(port_outs) == len(jax_outs)
    for i, (p, j) in enumerate(zip(port_outs, jax_outs)):
        p = p.numpy()
        j = np.asarray(j)
        assert p.shape == j.shape, (i, p.shape, j.shape)
        if i == stats_idx:
            np.testing.assert_allclose(p, j.astype(np.float32), rtol=1e-6, atol=0.0)
        else:
            np.testing.assert_array_equal(p, j.astype(p.dtype), err_msg=f"output {i}")


@pytest.mark.parametrize("seed", SEEDS)
def test_event_scatter_matches_pallas(seed):
    args = event_inputs(seed)
    want = jax_kernels.fused_event_scatter(*args, interpret=True)
    got = port_kernels.fused_event_scatter(*(_t(a) for a in args))
    _assert_outputs(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_free_resources_matches_pallas(seed):
    args = free_inputs(seed)
    want = jax_kernels.fused_free_resources(*args, interpret=True)
    got = port_kernels.fused_free_resources(*(_t(a) for a in args))
    _assert_outputs(got, want, stats_idx=2)


@pytest.mark.parametrize("seed", SEEDS)
def test_select_cycle_commit_matches_pallas(seed):
    args, K = megakernel_inputs(seed)
    want = jax_kernels.fused_select_cycle_commit(*args, k_pods=K, interpret=True)
    got = port_kernels.fused_select_cycle_commit(*(_t(a) for a in args), k_pods=K)
    _assert_outputs(got, want, stats_idx=6)
    # The inputs do exercise parks and assignments.
    phase_out = got[2].numpy()
    assert (phase_out[args[3]] == 3).any() and (phase_out[args[3]] == 2).any()


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions and count
    nothing: a count means a CUDA launch."""
    port_kernels.reset_launches()
    args, K = megakernel_inputs(0)
    port_kernels.fused_select_cycle_commit(*(_t(a) for a in args), k_pods=K)
    port_kernels.fused_free_resources(*(_t(a) for a in free_inputs(0)))
    port_kernels.fused_event_scatter(*(_t(a) for a in event_inputs(0)))
    args, S = ca_up_inputs(0)
    ca_kernels.fused_ca_scale_up(*(_t(a) for a in args), n_slots=S)
    args, K = ca_down_inputs(0)
    ca_kernels.fused_ca_scale_down(*(_t(a) for a in args), k_sd=K)
    assert len(port_kernels.LAUNCHES) == 5
    assert all(v == 0 for v in port_kernels.LAUNCHES.values())


def test_wrappers_refuse_other_devices():
    """A wrapper runs the plain version only for CPU tensors; anything but
    CPU or CUDA raises instead of falling back."""
    args = [_t(a).to("meta") for a in free_inputs(0)]
    with pytest.raises(ValueError, match="unsupported device"):
        port_kernels.fused_free_resources(*args)
    args, K = ca_down_inputs(0)
    with pytest.raises(ValueError, match="unsupported device"):
        ca_kernels.fused_ca_scale_down(*(_t(a).to("meta") for a in args), k_sd=K)
