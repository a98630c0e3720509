"""Kernel-level parity: each of the port's six scheduling kernels (plain
PyTorch version on the CPU) against the JAX package's Pallas kernel in
interpret mode, on seeded inputs at small C, N, P, K (the two CA kernels'
parity is in test_torch_autoscale.py). The three cycle-route kernels are
also held against the XLA formulations they replace: the lax.scan cycle
(reference step.py:1683-1718) after the queue sort, and commit_cycle's
scatters (step.py:1436-1457).

The Pallas cycle kernels bound their loop by the deepest cluster of a
128-cluster lane tile; the port's, like the Pallas kernel on a lone
cluster, by each cluster's own. So the cycle kernels are compared with the
Pallas kernel run one cluster at a time on every output, and with the
batched call on every row a consumer reads (valid rows, and the
allocatables).

Tolerance: every output exactly equal, except the estimator stats rows
(count/total/total_sq/min/max), held to rtol 1e-6 — the compare_states
policy for float32 metric accumulators. Inputs carry ties in node scores
and queue keys (broken by queue seq, unique per pod as in real states),
lanes with no eligible pod, and event slots out of range (generators in
test_torch_cuda.py and ca_inputs.py). The CUDA kernels are held against these plain
versions on the card by chip_smoke.py and test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from ca_inputs import ca_down_inputs, ca_up_inputs
from test_torch_cuda import (
    commit_inputs,
    cycle_inputs,
    event_inputs,
    event_inputs_wide,
    free_inputs,
    free_inputs_wide,
    megakernel_inputs,
    t as _t,
)
from test_torch_reference import jax_kernels

import jax
import jax.numpy as jnp
from kubernetriks_tpu.batched.pipeline import DEFAULT_PROFILE as JAX_DEFAULT_PROFILE
from kubernetriks_tpu.batched.pipeline import profile_fit_score as jax_profile_fit_score
from kubernetriks_tpu.batched.step import lexsort_time_i32 as jax_lexsort
from kubernetriks_tpu.batched.timerep import TPair as JaxTPair

from kubernetriks_tpu_torch.ops import autoscale_kernel as ca_kernels
from kubernetriks_tpu_torch.ops import chaos_kernel as draw_kernel
from kubernetriks_tpu_torch.ops import scheduler_kernel as port_kernels

SEEDS = [0, 1, 2]
# The event and free tests' cases: the small generators at SEEDS, and the
# wide ones at C = 2 over a few thousand rows (several tiles of the tiled
# CUDA kernels, N and P not multiples of 16).
WIDE_SEEDS = [3, 4]


def _small_and_wide():
    return [pytest.param(s, False, id=str(s)) for s in SEEDS] + [
        pytest.param(s, True, id=f"wide-{s}") for s in WIDE_SEEDS
    ]


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


@pytest.mark.parametrize("seed, wide", _small_and_wide())
def test_event_scatter_matches_pallas(seed, wide):
    args = event_inputs_wide(seed) if wide else event_inputs(seed)
    want = jax_kernels.fused_event_scatter(*args, interpret=True)
    got = port_kernels.fused_event_scatter(*(_t(a) for a in args))
    _assert_outputs(got, want)


@pytest.mark.parametrize("seed, wide", _small_and_wide())
def test_free_resources_matches_pallas(seed, wide):
    args = free_inputs_wide(seed) if wide else free_inputs(seed)
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


@pytest.mark.parametrize("seed", SEEDS)
def test_select_cycle_commit_edge_lanes_match_pallas(seed):
    """The edge lanes (megakernel_inputs): -0.0 before +0.0, nothing
    fitting, equal scores, dead nodes. Lane 0's whole-key ties are left
    out: the reference takes queue seqs as unique per cluster (its pick is
    one-hot only then), so only the port's two versions are held there
    (test_torch_cuda.py)."""
    args, K = megakernel_inputs(seed, C=8, edges=True)
    args = tuple(a[1:] for a in args)
    want = jax_kernels.fused_select_cycle_commit(*args, k_pods=K, interpret=True)
    got = port_kernels.fused_select_cycle_commit(*(_t(a) for a in args), k_pods=K)
    _assert_outputs(got, want, stats_idx=6)


def _per_cluster(fn, args, **kwargs):
    """The Pallas kernel run on one cluster at a time, outputs stacked."""
    outs = [fn(*(a[c : c + 1] for a in args), **kwargs) for c in range(args[0].shape[0])]
    return [np.concatenate([np.asarray(o[i]) for o in outs]) for i in range(len(outs[0]))]


def _scan_cycle(alive, alloc_cpu, alloc_ram, valid, req_cpu, req_ram):
    """The reference's lax.scan cycle (step.py:1683-1718) over K sorted
    candidates: (assign, park, best, alloc_cpu, alloc_ram)."""
    C, N = alloc_cpu.shape
    alive = jnp.asarray(alive)

    def body(carry, xs):
        cpu, ram = carry
        v, rc, rr = xs
        fit, score = jax_profile_fit_score(JAX_DEFAULT_PROFILE, alive, cpu, ram, rc[:, None], rr[:, None])
        best = jnp.int32(N - 1) - jax.lax.argmax(score[:, ::-1], 1, jnp.int32)
        any_fit = fit.any(axis=1)
        assign = v & any_fit
        rows = jnp.arange(C, dtype=jnp.int32)
        best_c = jnp.clip(best, 0, None)
        cpu = cpu.at[rows, best_c].add(jnp.where(assign, -rc, 0))
        ram = ram.at[rows, best_c].add(jnp.where(assign, -rr, 0))
        return (cpu, ram), (assign, v & ~any_fit, best)

    xs = (jnp.asarray(valid).T, jnp.asarray(req_cpu).T, jnp.asarray(req_ram).T)
    (cpu, ram), outs = jax.lax.scan(body, (jnp.asarray(alloc_cpu), jnp.asarray(alloc_ram)), xs)
    return [np.asarray(o).T for o in outs] + [np.asarray(cpu), np.asarray(ram)]


@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_cycle_matches_pallas_and_scan(seed):
    args = cycle_inputs(seed)
    valid = args[3]
    got = [g.numpy() for g in port_kernels.fused_schedule_cycle(*(_t(a) for a in args))]
    _assert_outputs([_t(g) for g in got], _per_cluster(jax_kernels.fused_schedule_cycle, args, interpret=True))
    # The batched Pallas call: every row a consumer reads.
    want = [np.asarray(w) for w in jax_kernels.fused_schedule_cycle(*args, interpret=True)]
    np.testing.assert_array_equal(got[0], want[0])
    for i in (1, 2):
        np.testing.assert_array_equal(got[i][valid], want[i][valid])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    # The lax.scan formulation: park = valid & ~fit_any on valid rows.
    assign, park, best, cpu, ram = _scan_cycle(*args)
    np.testing.assert_array_equal(got[0], assign)
    np.testing.assert_array_equal((valid & ~got[1]), park)
    np.testing.assert_array_equal(got[2][valid], best[valid])
    np.testing.assert_array_equal(got[3], cpu)
    np.testing.assert_array_equal(got[4], ram)
    assert got[0].any() and park.any()
    # Rows past a cluster's last valid row stay zero.
    assert not got[1][1].any() and not got[2][1].any()


@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_cycle_edge_lanes_match_pallas(seed):
    """The edge lanes (cycle_inputs): nothing fitting, equal scores, dead
    nodes; against the Pallas kernel one cluster at a time."""
    args = cycle_inputs(seed, edges=True)
    got = port_kernels.fused_schedule_cycle(*(_t(a) for a in args))
    _assert_outputs(got, _per_cluster(jax_kernels.fused_schedule_cycle, args, interpret=True))
    assert (got[2][2][args[3][2]] == args[1].shape[1] - 1).all()  # nothing fits: the last node


@pytest.mark.parametrize("seed", SEEDS)
def test_select_schedule_cycle_matches_pallas_and_sorted_scan(seed):
    margs, K = megakernel_inputs(seed)
    args = margs[:9]
    got = [g.numpy() for g in port_kernels.fused_select_schedule_cycle(*(_t(a) for a in args), k_pods=K)]
    _assert_outputs(
        [_t(g) for g in got],
        _per_cluster(jax_kernels.fused_select_schedule_cycle, args, k_pods=K, interpret=True),
    )
    # The sorted route: the queue sort's top K, then the lax.scan cycle.
    alive, alloc_cpu, alloc_ram, eligible, qwin, qoff, qseq, req_cpu, req_ram = args
    C, P = eligible.shape
    inf_win = np.int32(1 << 29)
    order = np.asarray(jax_lexsort(
        JaxTPair(jnp.where(eligible, qwin, inf_win), jnp.where(eligible, qoff, 0.0)),
        jnp.where(eligible, qseq, np.iinfo(np.int32).max),
    ))[:, :K]
    valid = np.take_along_axis(eligible, order, 1)
    assign, park, best, cpu, ram = _scan_cycle(
        alive, alloc_cpu, alloc_ram, valid,
        np.take_along_axis(req_cpu, order, 1), np.take_along_axis(req_ram, order, 1),
    )
    np.testing.assert_array_equal(got[1], valid)
    np.testing.assert_array_equal(got[0][valid], order[valid])
    np.testing.assert_array_equal(got[2], assign)
    np.testing.assert_array_equal(valid & ~got[3], park)
    np.testing.assert_array_equal(got[4][valid], best[valid])
    np.testing.assert_array_equal(got[5], cpu)
    np.testing.assert_array_equal(got[6], ram)


@pytest.mark.parametrize("seed", SEEDS)
def test_select_schedule_cycle_edge_lanes_match_pallas(seed):
    """The edge lanes (megakernel_inputs) through the two-kernel route's
    selection: -0.0 before +0.0, no eligible pod, fewer eligible pods than
    K, nothing fitting and every node dead (best is the last node), equal
    scores; against the Pallas kernel one cluster at a time. Lane 0's
    whole-key ties are left out, as in the megakernel's edge-lane test."""
    margs, K = megakernel_inputs(seed, C=8, edges=True)
    args = tuple(a[1:] for a in margs[:9])
    got = port_kernels.fused_select_schedule_cycle(*(_t(a) for a in args), k_pods=K)
    _assert_outputs(got, _per_cluster(jax_kernels.fused_select_schedule_cycle, args, k_pods=K, interpret=True))
    valid, best = got[1].numpy(), got[4].numpy()
    N = args[1].shape[1]
    for lane in (3, 5):  # nothing fits; every node dead
        assert valid[lane].any() and (best[lane][valid[lane]] == N - 1).all()
    assert not valid[0].any() and not got[0][0].any()  # no eligible pod: zero rows


def _xla_commit(cand, assign, park, best, start_s, park_s, phase, node):
    """commit_cycle's XLA scatters (reference step.py:1436-1457)."""
    C, P = phase.shape
    rows = jnp.arange(C, dtype=jnp.int32)[:, None]
    new_phase = jnp.where(assign, 3, jnp.where(park, 2, -1)).astype(jnp.int32)
    touched = assign | park
    inf = jnp.float32(np.inf)
    return [np.asarray(x) for x in (
        jnp.asarray(phase).at[rows, jnp.where(touched, cand, P)].set(jnp.where(touched, new_phase, 0), mode="drop"),
        jnp.asarray(node).at[rows, jnp.where(assign, cand, P)].set(jnp.where(assign, best, 0), mode="drop"),
        jnp.full((C, P), inf).at[rows, jnp.where(assign, cand, P)].set(jnp.where(assign, start_s, inf), mode="drop"),
        jnp.full((C, P), inf).at[rows, jnp.where(park, cand, P)].set(jnp.where(park, park_s, inf), mode="drop"),
    )]


@pytest.mark.parametrize("seed", SEEDS)
def test_commit_scatter_matches_pallas_and_xla(seed):
    args = commit_inputs(seed)
    got = port_kernels.fused_commit_scatter(*(_t(a) for a in args))
    _assert_outputs(got, jax_kernels.fused_commit_scatter(*args, interpret=True))
    _assert_outputs(got, _xla_commit(*args))
    assert (got[2].numpy() < np.inf).any() and (got[3].numpy() < np.inf).any()


@pytest.mark.parametrize("N, P, want", [
    (256, 2048, (2048, 1, True, 4 * 2048 + 8 * 256)),  # the headline: one block of 128 threads
    (301, 3001, (4096, 1, True, 4 * 4096 + 8 * 301)),  # one block of 256 threads
    (1713, 107136, (4096, 27, False, 4 * 4096 + 4 * 28)),  # the replay: the cross-block step
    (30000, 600, (2048, 1, False, 4 * 2048 + 4 * 2)),  # node rows too wide for shared memory
])
def test_free_layout_picks_the_block_and_the_node_path(N, P, want):
    """The free kernel's launch layout as its wrapper reckons it (the CUDA
    side computes the same from N and P): the block size by P, the node
    rows in shared memory only for one tile that fits, and no refusal for
    any N."""
    assert port_kernels.free_layout(N, P) == want


@pytest.mark.parametrize("N, S, K, want", [
    (96, 64, 8, (32, 4, 64, 96 + 32 + 64 * 99)),  # the autoscaler path: one warp
    (1713, 400, 8, (448, 4, 400, 1713 + 32 + 400 * 99)),  # the replay: 448 threads
    (1713, 5000, 8, (448, 4, 2319, 1713 + 32 + 2319 * 99)),  # windows of 2 319 candidates
    (97, 40, 8, (32, 4, 40, 97 + 32 + 40 * 99)),  # N not a multiple of the block
    (4096, 64, 8, (1024, 4, 64, 4096 + 32 + 64 * 99)),  # the largest block
    (12000, 64, 8, (1024, 16, 64, 12000 + 32 + 64 * 99)),  # 16 slots a thread
    (40000, 10, 8, (1024, 64, 10, 40000 + 32 + 10 * 99)),  # 64 slots a thread: refused
    (70000, 10, 8, (1024, 128, 10, 70000 + 32 + 10 * 99)),  # beyond 32 slots a thread: refused
])
def test_ca_down_layout_picks_the_block_and_the_window(N, S, K, want):
    """The scale-down kernel's launch layout as its wrapper reckons it (the
    CUDA side takes it as given): ~4 node slots a thread in whole warps,
    rounded up to a power of two (the wrapper refuses more than 32), and
    every candidate in one window where shared memory holds their pod
    tables, else windows of as many as fit."""
    assert ca_kernels.ca_down_layout(N, S, K) == want


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions and count
    nothing: a count means a CUDA launch."""
    port_kernels.reset_launches()
    args, K = megakernel_inputs(0)
    port_kernels.fused_select_cycle_commit(*(_t(a) for a in args), k_pods=K)
    port_kernels.fused_select_schedule_cycle(*(_t(a) for a in args[:9]), k_pods=K)
    port_kernels.fused_schedule_cycle(*(_t(a) for a in cycle_inputs(0)))
    port_kernels.fused_commit_scatter(*(_t(a) for a in commit_inputs(0)))
    port_kernels.fused_free_resources(*(_t(a) for a in free_inputs(0)))
    port_kernels.fused_event_scatter(*(_t(a) for a in event_inputs(0)))
    args, S = ca_up_inputs(0)
    ca_kernels.fused_ca_scale_up(*(_t(a) for a in args), n_slots=S)
    args, K = ca_down_inputs(0)
    ca_kernels.fused_ca_scale_down(*(_t(a) for a in args), k_sd=K)
    C, P = 2, 16
    draw_kernel.pod_attempt_draw(
        torch.zeros((C, P)), torch.zeros((C, P), dtype=torch.int32), torch.ones((C, P), dtype=torch.int32),
        torch.zeros((C, P)), torch.zeros((C, P), dtype=torch.bool), torch.zeros((C,), dtype=torch.int32),
        seed=1, plain_width=P, fail_prob=0.5, interval=10.0,
    )
    from test_torch_razor import run_glue_wrappers

    run_glue_wrappers()
    from kubernetriks_tpu_torch.ops.telemetry_kernel import telemetry_record

    C, N, P, R = 2, 3, 4, 8
    i32 = torch.int32
    buf, cursor, m0 = torch.full((C, R, 12), -1, dtype=i32), torch.zeros((C,), dtype=i32), torch.zeros((10, C), dtype=i32)
    telemetry_record(
        torch.ones((C, P), dtype=i32), torch.ones((C, N), dtype=torch.bool), None, None, None,
        torch.zeros((C,), dtype=i32), torch.full((C,), 5, dtype=i32), [torch.ones((C,), dtype=i32)] * 10, m0, buf,
        cursor, head_bound=P,
    )
    assert buf[:, 0].tolist() == [[5, 1, P, 0, 2, 2, 5, N, 0, 0, P, 1]] * C and cursor.tolist() == [1, 1]
    assert len(port_kernels.LAUNCHES) == 14
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
