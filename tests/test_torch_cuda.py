"""Tests of the port that need the card (marker `cuda`; skipped, with the
reason, where torch sees no CUDA device). This file imports torch and the
port only — no jax — so it also runs on a machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

It also holds the seeded input generators the CPU parity tests share (the
CA kernels' are in ca_inputs.py, beside chip_smoke.py)."""

import numpy as np
import pytest
import torch

from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
from kubernetriks_tpu_torch.batched.state import compare_states, flatten
from kubernetriks_tpu_torch.config import SimulationConfig
from kubernetriks_tpu_torch.convert import state_from_numpy, state_to_numpy
from kubernetriks_tpu_torch.ops import autoscale_kernel as ca_kernels
from kubernetriks_tpu_torch.ops import scheduler_kernel as port_kernels
from kubernetriks_tpu_torch.trace.generic import GenericClusterTrace, GenericWorkloadTrace

from ca_inputs import ca_down_inputs, ca_up_inputs
from chip_smoke import REORDER_WAVES, composed_sim, endurance_sim  # noqa: F401  (the scenarios, shared)

DELAYS = """sim_name: test_kubernetriks
seed: 123
scheduling_cycle_interval: 10.0
as_to_ps_network_delay: 0.050
ps_to_sched_network_delay: 0.010
sched_to_as_network_delay: 0.020
as_to_node_network_delay: 0.150
as_to_ca_network_delay: 0.30
as_to_hpa_network_delay: 0.40
"""


@pytest.fixture
def cuda_device():
    """Decided at run time, never at import or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def churn_yaml(seed: int):
    """(cluster, workload) generic YAML: four nodes arriving at random
    times, n0 removed at t=120, and 25-40 pods of mixed sizes (12000 mCPU
    fits no node: those park)."""
    rng = np.random.default_rng(seed)
    cluster = ["events:"]
    for i in range(4):
        ts = round(float(rng.uniform(1.0, 20.0)), 1)
        cluster.append(
            f"""
- timestamp: {ts}
  event_type:
    !CreateNode
      node:
        metadata: {{name: n{i}}}
        status: {{capacity: {{cpu: 8000, ram: 17179869184}}}}"""
        )
    cluster.append(
        """
- timestamp: 120.0
  event_type:
    !RemoveNode
      node_name: n0"""
    )
    workload = ["events:"]
    for i in range(int(rng.integers(25, 40))):
        ts = round(float(rng.uniform(2.0, 300.0)), 1)
        cpu = int(rng.choice([1000, 2000, 4000, 12000]))
        dur = round(float(rng.uniform(15.0, 90.0)), 1)
        workload.append(
            f"""
- timestamp: {ts}
  event_type:
    !CreatePod
      pod:
        metadata: {{name: p{i:03d}}}
        spec:
          resources:
            requests: {{cpu: {cpu}, ram: {cpu * 1048576}}}
            limits: {{cpu: {cpu}, ram: {cpu * 1048576}}}
          running_duration: {dur}"""
        )
    return "".join(cluster), "".join(workload)


def event_inputs(seed, C=4, E=8, N=8, P=16):
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 5, (C, E)).astype(np.int32)
    # Slots include out-of-range ones on both axes (dropped).
    slot = rng.integers(-2, max(N, P) + 3, (C, E)).astype(np.int32)
    slot[0, 0] = 1 << 29
    rel = rng.choice(np.float32([0.0, 0.5, 3.25, 7.0]), (C, E)).astype(np.float32)
    seq = rng.integers(0, 100, (C, E)).astype(np.int32)
    n_valid = rng.integers(0, E + 1, C)
    n_valid[1] = 0  # a lane with no due event
    valid = np.arange(E)[None, :] < n_valid[:, None]  # per-lane prefix
    created = rng.random((C, N)) < 0.3
    nrm = np.where(rng.random((C, N)) < 0.5, np.inf, rng.uniform(0, 9, (C, N))).astype(np.float32)
    pcr = np.where(rng.random((C, P)) < 0.7, np.inf, rng.uniform(0, 9, (C, P))).astype(np.float32)
    pseq = rng.integers(0, 50, (C, P)).astype(np.int32)
    prm = np.where(rng.random((C, P)) < 0.7, np.inf, rng.uniform(0, 9, (C, P))).astype(np.float32)
    return kind, slot, rel, seq, valid, created, nrm, pcr, pseq, prm


def free_inputs(seed, C=4, N=8, P=24):
    rng = np.random.default_rng(seed)
    freed = rng.random((C, P)) < 0.4
    freed[2] = False  # a lane that frees nothing
    node = np.where(freed, rng.integers(0, N, (C, P)), rng.integers(-1, N, (C, P))).astype(np.int32)
    req_cpu = rng.choice([500, 1000, 4000], (C, P)).astype(np.int32)
    req_ram = rng.choice([256, 1024, 8192], (C, P)).astype(np.int32)
    finishes = freed & (rng.random((C, P)) < 0.7)
    value = rng.uniform(30.0, 120.0, (C, P)).astype(np.float32)
    alloc_cpu = rng.integers(0, 64000, (C, N)).astype(np.int32)
    alloc_ram = rng.integers(0, 131072, (C, N)).astype(np.int32)
    return freed, node, req_cpu, req_ram, finishes, value, alloc_cpu, alloc_ram


def event_inputs_wide(seed, C=2, E=64, N=301, P=4999):
    """event_inputs at widths that span several of event_scatter.cu's
    tiles: every lane's valid prefix holds events on both sides of every
    tile boundary (once with a pod kind, once with a node kind), at the row
    ends and out of range (-1, N, P, 1 << 29), a few slots repeated with
    other times and seqs (the min/max combine in chunk order), and a run of
    12 consecutive slots three times over, as a chunk's creations come
    (many events on one warp, several on one thread); the rest are random
    slots, and each lane leaves 0-3 events invalid at its end. E grows to
    hold them."""
    rng = np.random.default_rng(seed)
    tile = port_kernels.EVENT_TILE
    edges = [r for b in range(tile, max(N, P) + 1, tile) for r in (b - 1, b)]
    pool = np.array(edges + [0, N - 1, N, P - 1, P, -1, 1 << 29], np.int64)
    must = 2 * len(pool) + 8 + 36
    E = max(E, must + 8)
    kind = rng.integers(0, 5, (C, E)).astype(np.int32)
    slot = rng.integers(-2, max(N, P) + 3, (C, E)).astype(np.int32)
    for c in range(C):
        dups = rng.choice(pool, 8)
        run = np.tile(int(rng.integers(0, min(N, P) - 12)) + np.arange(12), 3)
        lane_slots = np.concatenate([pool, pool, dups, run])
        lane_kinds = np.concatenate([
            rng.integers(3, 5, len(pool)), rng.integers(1, 3, len(pool)), rng.integers(1, 5, 8),
            rng.integers(1, 5, 36),
        ])
        order = rng.permutation(must)
        slot[c, :must] = lane_slots[order]
        kind[c, :must] = lane_kinds[order]
    rel = rng.choice(np.float32([0.0, 0.5, 3.25, 7.0]), (C, E)).astype(np.float32)
    seq = rng.integers(0, 100, (C, E)).astype(np.int32)
    valid = np.arange(E)[None, :] < (E - rng.integers(0, 4, C))[:, None]
    created = rng.random((C, N)) < 0.3
    nrm = np.where(rng.random((C, N)) < 0.5, np.inf, rng.uniform(0, 9, (C, N))).astype(np.float32)
    pcr = np.where(rng.random((C, P)) < 0.7, np.inf, rng.uniform(0, 9, (C, P))).astype(np.float32)
    pseq = rng.integers(0, 50, (C, P)).astype(np.int32)
    prm = np.where(rng.random((C, P)) < 0.7, np.inf, rng.uniform(0, 9, (C, P))).astype(np.float32)
    return kind, slot, rel, seq, valid, created, nrm, pcr, pseq, prm


def free_inputs_wide(seed, C=2, N=301, P=4999, dense_tile=None, idle=()):
    """free_inputs at widths that span several of free_resources.cu's
    tiles: freed pods on both sides of every tile boundary, at the row
    ends and across a 16-row run, and eight scattered ones per tile, most
    of them finished (the fold runs over several tiles in slot order);
    with `dense_tile` every pod of that tile of lane 0 freed; the lanes in
    `idle` free nothing."""
    rng = np.random.default_rng(seed)
    tile = port_kernels.FREE_TILE
    n_tiles = -(-P // tile)
    freed = np.zeros((C, P), bool)
    edges = [r for b in range(tile, P, tile) for r in (b - 1, b)] + [0, 15, 16, 17, P - 1]
    for c in range(C):
        freed[c, edges] = True
        freed[c, rng.integers(0, P, 8 * n_tiles)] = True
    if dense_tile is not None:
        freed[0, dense_tile * tile : (dense_tile + 1) * tile] = True
    freed[list(idle)] = False
    node = np.where(freed, rng.integers(0, N, (C, P)), rng.integers(-1, N, (C, P))).astype(np.int32)
    node[:, 0] = N - 1
    req_cpu = rng.choice([500, 1000, 4000], (C, P)).astype(np.int32)
    req_ram = rng.choice([256, 1024, 8192], (C, P)).astype(np.int32)
    finishes = freed & (rng.random((C, P)) < 0.7)
    value = rng.uniform(30.0, 120.0, (C, P)).astype(np.float32)
    alloc_cpu = rng.integers(0, 64000, (C, N)).astype(np.int32)
    alloc_ram = rng.integers(0, 131072, (C, N)).astype(np.int32)
    return freed, node, req_cpu, req_ram, finishes, value, alloc_cpu, alloc_ram


def megakernel_inputs(seed, C=4, N=8, P=24, K=6, edges=False):
    """Megakernel operands. With `edges` (C >= 7) lanes 0, 2, 4, 5 and 6
    are replaced by the cases each design must hold exactly: queue keys
    tied on (win, off, seq) so the slot decides (0), offsets of -0.0 and
    +0.0 (2), nothing fits (4: best is the last node), all scores equal
    (5: the last node wins) and every node dead (6); lane 1 has no
    eligible pod, lane 3 fewer than K."""
    rng = np.random.default_rng(seed)
    alive = rng.random((C, N)) < 0.8
    # Few distinct allocatables and requests: equal scores on several
    # nodes (ties go to the highest slot) and nodes that fit nothing.
    alloc_cpu = rng.choice([0, 4000, 8000, 16000], (C, N)).astype(np.int32)
    alloc_ram = rng.choice([0, 4096, 8192, 16384], (C, N)).astype(np.int32)
    eligible = rng.random((C, P)) < 0.6
    eligible[1] = False  # a lane with no eligible pod
    eligible[3, :2] = True
    eligible[3, 2:] = False  # a lane with fewer eligible pods than K
    # Queue keys with ties in (win, off): seq decides, unique per lane.
    qwin = rng.integers(0, 3, (C, P)).astype(np.int32)
    qoff = rng.choice(np.float32([0.0, 0.5, 2.25]), (C, P)).astype(np.float32)
    qseq = np.stack([rng.permutation(P) for _ in range(C)]).astype(np.int32)
    req_cpu = rng.choice([1000, 2000, 4000, 12000], (C, P)).astype(np.int32)
    req_ram = rng.choice([1024, 2048, 4096, 12288], (C, P)).astype(np.int32)
    waited = rng.uniform(0.0, 50.0, (C, P)).astype(np.float32)
    phase = rng.integers(0, 4, (C, P)).astype(np.int32)
    node = rng.integers(-1, N, (C, P)).astype(np.int32)
    if edges:
        qwin[0], qoff[0], qseq[0] = 1, np.float32(0.5), 7
        qwin[2] = 0
        qoff[2] = rng.choice(np.float32([-0.0, 0.0]), P)
        alloc_cpu[4] = 0
        alive[5] = True
        alloc_cpu[5], alloc_ram[5] = 16000, 16384
        alive[6] = False
    step = rng.uniform(1e-6, 1e-5, (C, 1)).astype(np.float32)
    cd_post = np.cumsum(np.broadcast_to(step, (C, K)), axis=1).astype(np.float32)
    qpre_t = (cd_post - step).astype(np.float32)
    start_t = (cd_post + np.float32(0.27)).astype(np.float32)
    park_t = cd_post
    return (
        alive, alloc_cpu, alloc_ram, eligible, qwin, qoff, qseq, req_cpu, req_ram,
        waited, phase, node, qpre_t, start_t, park_t,
    ), K


def cycle_inputs(seed, C=5, N=8, K=6, edges=False):
    """Candidate-cycle operands: valid rows a prefix per cluster, as the
    queue sort leaves them (a lane with none, a lane with all K), requests
    past the prefix from other pods, ties in node scores and requests that
    fit nowhere. With `edges` (C >= 5) lanes 2, 3 and 4 are replaced by a
    lane where nothing fits (best is the last node), one where all scores
    are equal (the last node wins) and one with every node dead."""
    rng = np.random.default_rng(seed)
    alive = rng.random((C, N)) < 0.8
    alloc_cpu = rng.choice([0, 4000, 8000, 16000], (C, N)).astype(np.int32)
    alloc_ram = rng.choice([0, 4096, 8192, 16384], (C, N)).astype(np.int32)
    n_valid = rng.integers(1, K, C)
    n_valid[0] = K
    n_valid[1:2] = 0
    valid = np.arange(K)[None, :] < n_valid[:, None]
    req_cpu = rng.choice([1000, 2000, 4000, 12000], (C, K)).astype(np.int32)
    req_ram = rng.choice([1024, 2048, 4096, 12288], (C, K)).astype(np.int32)
    if edges:
        alloc_cpu[2] = 0
        alive[3] = True
        alloc_cpu[3], alloc_ram[3] = 16000, 16384
        alive[4] = False
    return alive, alloc_cpu, alloc_ram, valid, req_cpu, req_ram


def commit_inputs(seed, C=5, P=24, K=6):
    """Commit-scatter operands: unique candidate slots per cluster, a valid
    prefix split into assigned and parked rows (a lane with none), and
    pod rows to write into."""
    rng = np.random.default_rng(seed)
    cand = np.stack([rng.permutation(P)[:K] for _ in range(C)]).astype(np.int32)
    n_valid = rng.integers(0, K + 1, C)
    n_valid[1] = 0
    valid = np.arange(K)[None, :] < n_valid[:, None]
    fits = rng.random((C, K)) < 0.6
    assign = valid & fits
    park = valid & ~fits
    best = rng.integers(0, 8, (C, K)).astype(np.int32)
    start_s = rng.uniform(0.0, 1.0, (C, K)).astype(np.float32)
    park_s = rng.uniform(0.0, 1.0, (C, K)).astype(np.float32)
    phase = rng.integers(0, 4, (C, P)).astype(np.int32)
    node = rng.integers(-1, 8, (C, P)).astype(np.int32)
    return cand, assign, park, best, start_s, park_s, phase, node


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6])
def test_ca_kernels_match_plain_versions(cuda_device, seed):
    """Each CA kernel equals its plain version exactly on the same card
    inputs, at the test shapes, at the composed path's widths (N=96, S=64,
    K_sd=8; Gn=1, K_up=64) and at the replay's (C = 1 and 2, N = 1 713 (not
    a multiple of the block), S = 400), on the generators' edge cases
    (branch off, nothing eligible, everything eligible, a removal pushing a
    later candidate over the threshold, a removed node as a later target,
    more than K and no pods, negative requests, K = 12, blocks of 1 024
    threads with 8 and 16 node slots a thread; no valid cache row, all
    valid, a consumed reserve with Gn = 2, opens on planned slots), and
    counts one launch per call. Each call runs twice: nothing may carry
    over between calls."""
    cases = []
    down = [{}, {"C": 64, "N": 96, "S": 64, "K": 8}, {"N": 97, "S": 40, "K": 8},
            {"C": 1, "N": 1713, "S": 400, "K": 8}, {"C": 2, "N": 1713, "S": 400, "K": 8}]
    for edge in ("crossing", "target", "branch_off", "none_eligible", "all_eligible", "attempting", "negative"):
        down += [{"edge": edge}, {"C": 2, "N": 1713, "S": 400, "K": 8, "edge": edge}]
    # K = 12 pod rows a candidate, and blocks of 32 warps with 8 and 16 node
    # slots a thread.
    down += [{"N": 97, "S": 40, "K": 12, "edge": "attempting"},
             {"C": 2, "N": 1713, "S": 400, "K": 12, "edge": "attempting"},
             {"C": 2, "N": 5000, "S": 300, "K": 8, "edge": "attempting"},
             {"C": 1, "N": 12000, "S": 100, "K": 8, "edge": "attempting"}]
    for kw in down:
        args, K = ca_down_inputs(seed, **kw)
        cases.append(("fused_ca_scale_down", ca_kernels.ca_scale_down_plain, args, {"k_sd": K}))
    up = [{}, {"C": 5, "G": 1, "K": 64, "S": 64}, {"C": 1, "G": 1, "K": 64, "S": 400},
          {"C": 2, "G": 1, "K": 64, "S": 400}, {"C": 40, "G": 2, "K": 70, "S": 400}]
    for edge in ("none_valid", "all_valid", "overlap"):
        up += [{"edge": edge}, {"C": 2, "G": 1, "K": 64, "S": 400, "edge": edge}]
    for kw in up:
        args, S = ca_up_inputs(seed, **kw)
        cases.append(("fused_ca_scale_up", ca_kernels.ca_scale_up_plain, args, {"n_slots": S}))
    for name, plain, args, kwargs in cases:
        dev_args = [t(a).to(cuda_device) for a in args]
        want = plain(*dev_args, **kwargs)
        for _ in range(2):
            port_kernels.reset_launches()
            got = getattr(ca_kernels, name)(*dev_args, **kwargs)
            torch.cuda.synchronize()
            assert port_kernels.LAUNCHES[name] == 1
            for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
                assert torch.equal(g, w), name


@pytest.mark.cuda
def test_ca_scale_down_in_narrow_windows(cuda_device, monkeypatch):
    """With the shared-memory budget cut so a window holds a few
    candidates, the scale-down walks S in several windows (the node rows
    loaded once, in the first window that has an eligible candidate) and
    still equals its plain version."""
    args, K = ca_down_inputs(7, C=2, N=1713, S=400, K=8, edge="attempting")
    threads, npt, window, smem = ca_kernels.ca_down_layout(1713, 400, 8)
    budget = ca_kernels._CA_DOWN_STATIC_SMEM + smem - (35 + 8 * 8) * (window - 37)
    monkeypatch.setattr(ca_kernels, "SMEM_LIMIT", budget)
    assert ca_kernels.ca_down_layout(1713, 400, 8)[2] == 37
    dev_args = [t(a).to(cuda_device) for a in args]
    got = ca_kernels.fused_ca_scale_down(*dev_args, k_sd=K)
    torch.cuda.synchronize()
    assert torch.equal(got, ca_kernels.ca_scale_down_plain(*dev_args, k_sd=K))


@pytest.mark.cuda
@pytest.mark.parametrize("reclaim", [True, False])
def test_autoscaler_state_handoff_on_card(cuda_device, reclaim):
    """A CPU run's state with pending autoscaler effects, installed into a
    card engine, runs on through both CA kernels to the CPU run's end
    state, with slot reclaim on both sides (the card's default) and off on
    both."""
    cpu = composed_sim("cpu", 2, reclaim=reclaim)
    cpu.step_until_time(280.0)
    flat = state_to_numpy(cpu.state)
    assert (flat[".nodes.remove_time.win"] < 1 << 29).any()  # a CA removal pending
    card = composed_sim(cuda_device, 2, **({} if reclaim else {"reclaim": False}))
    assert card.reclaim == reclaim
    card.install_state(state_from_numpy(flat), cpu.next_window_idx)
    port_kernels.reset_launches()
    card.step_until_time(400.0)
    cpu.step_until_time(400.0)
    assert port_kernels.LAUNCHES["fused_ca_scale_down"] > 0
    assert port_kernels.LAUNCHES["fused_ca_scale_up"] > 0
    assert compare_states(state_to_numpy(cpu.state), state_to_numpy(card.state)) == []


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6])
def test_cuda_kernels_match_plain_versions(cuda_device, seed):
    """Each CUDA kernel equals its plain version on the same card inputs
    (stats rows to rtol 1e-6) and counts exactly one launch; the
    megakernel also on the edge lanes (megakernel_inputs), at the
    headline's widths with depth above K, and with K = P = 2 048 (the
    queue ordered in several batches), with a queue of 257-512 pods and
    K = P (one sort, two batches), at N = 300 and N = 1 713 on a deep queue
    (160 and 864 threads: windows of one offer a thread, and a last group
    of 96 threads), and at C = 128 with P = 20 480 and K = 1 024 (a shape
    past the old selection kernel's shared memory, which now runs dense)."""
    mega = [
        megakernel_inputs(seed),
        megakernel_inputs(seed, C=8, edges=True),
        megakernel_inputs(seed, C=8, N=256, P=2048, K=64, edges=True),
        megakernel_inputs(seed, C=8, N=256, P=2048, K=2048, edges=True),
        megakernel_inputs(seed, C=8, N=256, P=640, K=640, edges=True),
        megakernel_inputs(seed, C=8, N=300, P=2048, K=2048, edges=True),
        megakernel_inputs(seed, C=8, N=1713, P=2048, K=512, edges=True),
        megakernel_inputs(seed, C=128, N=8, P=20480, K=1024),
    ]
    cases = [
        ("fused_event_scatter", port_kernels.event_scatter_plain, event_inputs(seed), {}, None),
        ("fused_free_resources", port_kernels.free_resources_plain, free_inputs(seed), {}, 2),
    ] + [
        ("fused_select_cycle_commit", port_kernels.select_cycle_commit_plain, margs, {"k_pods": K}, 6)
        for margs, K in mega
    ]
    for name, plain, args, kwargs, stats_idx in cases:
        port_kernels.reset_launches()
        dev_args = [t(a).to(cuda_device) for a in args]
        got = getattr(port_kernels, name)(*dev_args, **kwargs)
        torch.cuda.synchronize()
        assert port_kernels.LAUNCHES[name] == 1
        want = plain(*dev_args, **kwargs)
        for i, (g, w) in enumerate(zip(got, want)):
            if i == stats_idx:
                torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)
            else:
                assert torch.equal(g, w), (name, i)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6])
def test_tiled_event_and_free_kernels_match_plain_versions(cuda_device, seed):
    """The two kernels that spread a cluster over tiles equal their plain
    versions on the same card inputs (outputs exact, stats rows to rtol
    1e-6) and count one launch per call: at the replay's width (N = 1 713,
    P = 107 136) with C = 1 and 2, at the headline's (N = 256, P = 2 048),
    and at N and P that are not multiples of 16 (clusters 1 and 2 start
    unaligned, so the vector loads fall back); the free kernel also with
    one tile wholly freed, a cluster that frees nothing, one block of each
    size (P = 2 048 and 3 001), and node rows too wide for shared memory
    (the cross-block path at one tile). Each case runs twice, so the free kernel's scratch
    shows that it leaves itself zero."""
    plain_ev, plain_free = port_kernels.event_scatter_plain, port_kernels.free_resources_plain
    cases = [
        ("fused_event_scatter", plain_ev, event_inputs_wide(seed, C=1, E=320, N=1713, P=107136), None),
        ("fused_event_scatter", plain_ev, event_inputs_wide(seed, C=2, E=320, N=1713, P=107136), None),
        ("fused_event_scatter", plain_ev, event_inputs_wide(seed, C=3, N=2053, P=9001), None),
        ("fused_event_scatter", plain_ev, event_inputs_wide(seed, C=8, N=256, P=2048), None),
        ("fused_free_resources", plain_free, free_inputs_wide(seed, C=1, N=1713, P=107136), 2),
        ("fused_free_resources", plain_free,
         free_inputs_wide(seed, C=2, N=1713, P=107136, dense_tile=3, idle=(1,)), 2),
        ("fused_free_resources", plain_free, free_inputs_wide(seed, C=3, N=301, P=9001, idle=(1,)), 2),
        ("fused_free_resources", plain_free, free_inputs_wide(seed, C=2, N=30000, P=600), 2),
        ("fused_free_resources", plain_free, free_inputs_wide(seed, C=8, N=256, P=2048), 2),
        ("fused_free_resources", plain_free, free_inputs_wide(seed, C=3, N=301, P=3001, idle=(1,)), 2),
    ]
    for name, plain, args, stats_idx in cases:
        dev_args = [t(a).to(cuda_device) for a in args]
        want = plain(*dev_args)
        for _ in range(2):
            port_kernels.reset_launches()
            got = getattr(port_kernels, name)(*dev_args)
            torch.cuda.synchronize()
            assert port_kernels.LAUNCHES[name] == 1
            for i, (g, w) in enumerate(zip(got, want)):
                if i == stats_idx:
                    torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)
                else:
                    assert torch.equal(g, w), (name, args[0].shape, i)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6])
def test_cycle_route_kernels_match_plain_versions(cuda_device, seed):
    """The sorted and two-kernel routes' kernels equal their plain versions
    exactly on the same card inputs, at the test shapes and at the replay's
    and the headline's widths, and count one launch per call; the
    candidate cycle also on the edge lanes (cycle_inputs), at the replay's
    N = 1 713 (not a multiple of its block) with K = 1 024; the selection
    kernel also on the edge lanes (megakernel_inputs), with K = P = 2 048
    at the headline's width (the queue ordered in several batches), with a
    queue of 257-512 pods and K = P, at N = 300 and N = 1 713 on a deep
    queue, and at C = 128, N = 8, P = 20 480, K = 1 024 (past its old
    shared-memory limit)."""
    selection = [
        megakernel_inputs(seed),
        megakernel_inputs(seed, C=8, edges=True),
        megakernel_inputs(seed, C=8, N=256, P=2048, K=64),
        megakernel_inputs(seed, C=8, N=256, P=2048, K=2048, edges=True),
        megakernel_inputs(seed, C=8, N=256, P=640, K=640, edges=True),
        megakernel_inputs(seed, C=8, N=300, P=2048, K=2048, edges=True),
        megakernel_inputs(seed, C=8, N=1713, P=2048, K=512, edges=True),
        megakernel_inputs(seed, C=128, N=8, P=20480, K=1024),
    ]
    cases = [
        ("fused_schedule_cycle", port_kernels.schedule_cycle_plain, cycle_inputs(seed), {}),
        ("fused_schedule_cycle", port_kernels.schedule_cycle_plain, cycle_inputs(seed, edges=True), {}),
        ("fused_schedule_cycle", port_kernels.schedule_cycle_plain, cycle_inputs(seed, C=1, N=1713, K=256), {}),
        ("fused_schedule_cycle", port_kernels.schedule_cycle_plain,
         cycle_inputs(seed, N=1713, K=1024, edges=True), {}),
    ] + [
        ("fused_select_schedule_cycle", port_kernels.select_schedule_cycle_plain, margs[:9], {"k_pods": K})
        for margs, K in selection
    ] + [
        ("fused_commit_scatter", port_kernels.commit_scatter_plain, commit_inputs(seed), {}),
        ("fused_commit_scatter", port_kernels.commit_scatter_plain, commit_inputs(seed, C=64, P=2048, K=64), {}),
    ]
    for name, plain, args, kwargs in cases:
        port_kernels.reset_launches()
        dev_args = [t(a).to(cuda_device) for a in args]
        got = getattr(port_kernels, name)(*dev_args, **kwargs)
        torch.cuda.synchronize()
        assert port_kernels.LAUNCHES[name] == 1
        want = plain(*dev_args, **kwargs)
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (name, i)


@pytest.mark.cuda
def test_card_run_matches_cpu_run(cuda_device):
    """On the card the main path (below 128 clusters: the sorted route)
    goes through its three CUDA kernels and ends in the CPU run's state."""
    port_kernels.reset_launches()
    card = state_to_numpy(_churn_sim(cuda_device, 600.0).state)
    scheduling = ("fused_event_scatter", "fused_free_resources", "fused_schedule_cycle")
    assert all(port_kernels.LAUNCHES[n] > 0 for n in scheduling), port_kernels.LAUNCHES
    assert compare_states(state_to_numpy(_churn_sim("cpu", 600.0).state), card) == []


def _churn_sim(device, until: float):
    cluster_yaml, workload_yaml = churn_yaml(3)
    sim = build_batched_from_traces(
        SimulationConfig.from_yaml(DELAYS),
        GenericClusterTrace.from_yaml(cluster_yaml).convert_to_simulator_events(),
        GenericWorkloadTrace.from_yaml(workload_yaml).convert_to_simulator_events(),
        n_clusters=4, device=device, max_pods_per_cycle=8,
    )
    sim.step_until_time(until)
    return sim


@pytest.mark.cuda
def test_cpu_state_into_cuda_engine_raises(cuda_device):
    """A handed-over state must lie on the engine's device; state_from_numpy
    without a device puts it on the card."""
    flat = state_to_numpy(_churn_sim("cpu", 60.0).state)
    sim = _churn_sim(cuda_device, 0.0)
    with pytest.raises(ValueError, match="install_state: leaf .* is on cpu"):
        sim.install_state(state_from_numpy(flat, "cpu"), 7)
    sim.install_state(state_from_numpy(flat), 7)
    assert sim.state.pods.phase.device.type == "cuda"


# --- the graph executor against eager windows ------------------------------------


def _graph_and_eager(build, until, route=None, switch=None):
    """The same windows on the card twice: replaying the window graphs
    (every reachable piece captured up front) and eagerly (graphs=False).
    `until` None runs to completion. `switch`: (time, route) to force
    another route at `time` on both. Returns [(sim, launches, host syncs)] for the graph run, then the
    eager one."""
    runs = []
    for graphs in (True, False):
        sim = build(graphs)
        if route:
            sim.cycle_route = route
        sim.precompile_pieces()
        port_kernels.reset_launches()
        syncs = sim.host_syncs
        if switch:
            sim.step_until_time(switch[0])
            sim.cycle_route = switch[1]
        if until is None:
            sim.run_to_completion()
        else:
            sim.step_until_time(until)
        torch.cuda.synchronize()
        runs.append((sim, port_kernels.launch_counts(), sim.host_syncs - syncs))
    return runs


def _assert_graph_run_equals_eager_run(runs, max_syncs=0):
    (g, g_launches, g_syncs), (e, e_launches, e_syncs) = runs
    assert g.graphs and not e.graphs
    stats = g.dispatch_stats
    assert stats["eager_windows"] == 0 and stats["graph_windows"] == g.windows_run > 0
    assert stats["replays"] > g.windows_run and e.dispatch_stats["replays"] == 0
    assert g.windows_run == e.windows_run
    fg, fe = flatten(g.state), flatten(e.state)
    assert [p for p in fg if not torch.equal(fg[p], fe[p])] == []
    # The eager run runs the razor's gated tails whatever their predicate
    # holds; the graphs' conditional nodes skip them where it is false.
    skipped = g._executor.skipped_body_launches()
    assert {n: k + skipped.get(n, 0) for n, k in g_launches.items()} == e_launches
    assert sum(g_launches.values()) > 0
    assert g_syncs == e_syncs <= max_syncs


def _churn_build(device, **kwargs):
    cluster_yaml, workload_yaml = churn_yaml(3)
    return build_batched_from_traces(
        SimulationConfig.from_yaml(DELAYS),
        GenericClusterTrace.from_yaml(cluster_yaml).convert_to_simulator_events(),
        GenericWorkloadTrace.from_yaml(workload_yaml).convert_to_simulator_events(),
        n_clusters=4, device=device, max_pods_per_cycle=8, **kwargs,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["megakernel", "two_kernel", "sorted"])
def test_graph_run_equals_eager_run_on_every_route(cuda_device, route):
    """Bit for bit, with the node removal's reschedules (the end piece on
    both of its removal keys): the same kernels and torch ops run in the same
    order, and every cross-block sum is integer or slot-ordered."""
    runs = _graph_and_eager(lambda g: _churn_build(cuda_device, graphs=g), 600.0, route)
    _assert_graph_run_equals_eager_run(runs)
    assert ("end", route, True, None, False) in runs[0][0]._executor.graphs


@pytest.mark.cuda
def test_autoscaler_graph_run_equals_eager_run(cuda_device):
    runs = _graph_and_eager(lambda g: composed_sim(cuda_device, 8, graphs=g), 400.0)
    _assert_graph_run_equals_eager_run(runs)
    assert runs[0][1]["fused_ca_scale_down"] > 0 and runs[0][1]["fused_ca_scale_up"] > 0
    counters = runs[0][0].metrics_summary()["counters"]
    assert counters["total_scaled_down_nodes"] > 0 and counters["total_scaled_up_nodes"] > 0


@pytest.mark.cuda
def test_replay_graph_run_equals_eager_run(cuda_device, tmp_path):
    """A short replay with the CA on, to completion (one host read per 64
    windows past the last event, on both runs)."""
    from chip_smoke import replay_sim
    from kubernetriks_tpu_torch.trace.synthetic_alibaba import write_synthetic_trace_dir

    paths = write_synthetic_trace_dir(str(tmp_path), n_machines=100, n_tasks=700, horizon=4000.0, seed=7)
    runs = _graph_and_eager(lambda g: replay_sim(cuda_device, paths, delays="test", graphs=g), None)
    _assert_graph_run_equals_eager_run(runs, max_syncs=-(-runs[0][0].windows_run // 64))
    assert runs[0][1]["fused_schedule_cycle"] > 0


@pytest.mark.cuda
def test_a_route_forced_after_the_build_recaptures(cuda_device):
    """The sorted route's graphs, then the megakernel's after the route is
    forced mid-run: a stale end graph never runs again."""
    runs = _graph_and_eager(
        lambda g: _churn_build(cuda_device, graphs=g), 400.0, switch=(150.0, "megakernel")
    )
    _assert_graph_run_equals_eager_run(runs)
    graphs = runs[0][0]._executor.graphs
    assert ("end", "sorted", False, None, False) in graphs and ("end", "megakernel", False, None, False) in graphs
    assert runs[0][1]["fused_select_cycle_commit"] == 25 and runs[0][1]["fused_schedule_cycle"] == 16


@pytest.mark.cuda
def test_ca_scale_down_above_48_kb_captures(cuda_device):
    """A scale-down launch that sets its kernel's dynamic shared-memory
    attribute (above 48 KB: every launch calls cudaFuncSetAttribute) is
    accepted by a CUDA graph capture, and its replay equals the plain
    version."""
    args, K = ca_down_inputs(7, C=2, N=1713, S=512, K=8, edge="attempting")
    assert ca_kernels.ca_down_layout(1713, 512, 8)[3] > 48 * 1024
    dev_args = [t(a).to(cuda_device) for a in args]
    ca_kernels.fused_ca_scale_down(*dev_args, k_sd=K)  # warm-up, as the executor's
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ca_kernels.fused_ca_scale_down(*dev_args, k_sd=K)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, ca_kernels.ca_scale_down_plain(*dev_args, k_sd=K))


# --- the sliding pod window -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6])
def test_kernels_match_plain_versions_at_a_windowed_pod_width(cuda_device, seed):
    """The sliding pod window keeps the pod axis at its exact width, the
    window plus the pod-group ring: here 250 + 5 = 255 slots, not a
    multiple of 4 (every cluster's rows after the first start unaligned,
    so the event scatter's 16-byte loads and the megakernel's vector copy
    fall back) nor of 256 (the queue's last batch is short). The event
    scatter, the free kernel and the three cycle-route kernels equal their
    plain versions (outputs exact, stats rows to rtol 1e-6), one launch a
    call."""
    P = 255
    cases = [
        ("fused_event_scatter", port_kernels.event_scatter_plain, event_inputs_wide(seed, C=3, N=96, P=P), {}, None),
        ("fused_free_resources", port_kernels.free_resources_plain, free_inputs_wide(seed, C=3, N=96, P=P), {}, 2),
    ]
    for C, K in ((8, 64), (8, P)):
        margs, _ = megakernel_inputs(seed, C=C, N=96, P=P, K=K, edges=True)
        cases.append(("fused_select_cycle_commit", port_kernels.select_cycle_commit_plain, margs, {"k_pods": K}, 6))
        cases.append(("fused_select_schedule_cycle", port_kernels.select_schedule_cycle_plain, margs[:9],
                      {"k_pods": K}, None))
    cases.append(("fused_commit_scatter", port_kernels.commit_scatter_plain, commit_inputs(seed, C=8, P=P, K=64),
                  {}, None))
    cases.append(("fused_schedule_cycle", port_kernels.schedule_cycle_plain, cycle_inputs(seed, N=96, K=64, edges=True),
                  {}, None))
    for name, plain, args, kwargs, stats_idx in cases:
        port_kernels.reset_launches()
        dev_args = [t(a).to(cuda_device) for a in args]
        got = getattr(port_kernels, name)(*dev_args, **kwargs)
        torch.cuda.synchronize()
        assert port_kernels.LAUNCHES[name] == 1
        want = plain(*dev_args, **kwargs)
        for i, (g, w) in enumerate(zip(got, want)):
            if i == stats_idx:
                torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)
            else:
                assert torch.equal(g, w), (name, i)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["megakernel", "sorted"])
def test_sliding_graph_run_equals_eager_run(cuda_device, route):
    """The composed toy through an 8-slot pod window (it slides and grows
    twice): the slide piece and the pieces captured again after each
    growth replay what the eager run does, bit for bit, with equal launch
    counts; each run reads the device once a span."""
    runs = _graph_and_eager(lambda g: composed_sim(cuda_device, 8, pod_window=8, graphs=g), 400.0, route)
    g = runs[0][0]
    stats = g.dispatch_stats
    assert stats["slides"] > 0 and stats["grows"] > 0
    _assert_graph_run_equals_eager_run(runs, max_syncs=stats["slides"] + stats["grows"])
    assert runs[0][2] == stats["slides"] + stats["grows"]
    assert g._executor.slide_key() in g._executor.graphs
    assert g.pod_window > 8 and g.n_pods == runs[1][0].n_pods


@pytest.mark.cuda
@pytest.mark.parametrize("n_waves", [24, REORDER_WAVES])
def test_endurance_churn_card_matches_cpu(cuda_device, n_waves):
    """The reference's endurance churn at its own defaults (4 clusters, 24
    waves through a 2-slot CA reserve, pod_window=128), and through wave
    74's pair (ca_node_99 and ca_node_100, walked out of slot order by the
    scale-down), with slot reclaim on both sides: the card's final state
    equals the CPU's; slots were reclaimed, the reserve was overrun 3
    times over and the bounds hold."""
    finals = {}
    for device in (cuda_device, "cpu"):
        sim = endurance_sim(device, n_waves=n_waves, reclaim=True)
        sim.step_until_time(30.0 + n_waves * 160.0)
        counters = sim.metrics_summary()["counters"]
        finals[str(device)] = state_to_numpy(sim.state)
    assert compare_states(finals[str(cuda_device)], finals["cpu"]) == []
    reserve = int(sim.autoscale_statics.ng_slot_count[0].sum())
    assert (sim.state.auto.ca_total >= 3 * reserve).all() and counters["ca_slots_reclaimed"] > 0


@pytest.mark.cuda
def test_endurance_churn_graph_run_equals_eager_run(cuda_device):
    """The same churn on the card, replayed from graphs and eagerly: the
    reclaim piece and every other replay equal the eager run bit for bit,
    launches and host reads (one a span of the pod window) included."""
    runs = _graph_and_eager(lambda g: endurance_sim(cuda_device, graphs=g), 30.0 + 24 * 160.0)
    g = runs[0][0]
    assert g.reclaim and ("reclaim",) in g._executor.graphs
    stats = g.dispatch_stats
    _assert_graph_run_equals_eager_run(runs, max_syncs=stats["slides"] + stats["grows"])
    assert int(g.ca_slots_reclaimed().sum()) > 0


@pytest.mark.cuda
def test_conditional_node_runs_its_body_only_where_the_flag_is_set(cuda_device):
    """CudaGraphs.when inside a capture: the body (a sort, a gather and a
    copy into a fixed buffer, as reclaim's compaction does) runs on a
    replay only where the device flag computed before it is set, and a
    replay reads nothing back."""
    from kubernetriks_tpu_torch.batched.graphs import CudaGraphs

    backend = CudaGraphs(torch.device(cuda_device))
    src = torch.arange(64, dtype=torch.int32, device=cuda_device).flip(0).contiguous()
    out = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    gate = torch.zeros((), dtype=torch.int32, device=cuda_device)

    def piece():
        flag = gate > 0

        def body():
            order = torch.sort(src, stable=True).indices
            out.copy_(torch.gather(src, 0, order) + gate)

        backend.when(flag, body)

    backend.warm(piece)  # uncaptured: the body runs whatever the flag
    want = torch.arange(64, dtype=torch.int32, device=cuda_device)
    assert torch.equal(out, want)
    graph = backend.capture(piece)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert not out.any()
    gate.fill_(5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want + 5)
    gate.fill_(0)
    out.fill_(-1)
    graph.replay()
    torch.cuda.synchronize()
    assert bool((out == -1).all())


PROFILE_SPECS = {
    "best_fit": "best_fit",
    "balanced_packing": "balanced_packing",
    "custom": {"filters": ["Fit"], "score": [{"name": "BalancedResourceAllocation", "weight": 2.0}]},
    "no_filter_three_terms": {
        "filters": [],
        "score": ["LeastAllocatedResources", "MostAllocatedResources", {"name": "BalancedResourceAllocation",
                                                                        "weight": 0.3}],
    },
    "scoreless": {"filters": ["Fit"], "score": []},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PROFILE_SPECS))
def test_profiled_cycle_kernels_match_plain_versions(cuda_device, name):
    """The three cycle kernels' general instantiation equals their plain
    versions under each profile, bit for bit (stats rows rtol 1e-6), on
    the edge lanes, at the headline's widths, with K = P = 2 048 and at
    the replay's N = 1 713, and counts one launch per call."""
    from kubernetriks_tpu_torch.batched.pipeline import compile_profile

    prof = compile_profile(PROFILE_SPECS[name])
    cases = []
    for margs, K in (
        megakernel_inputs(5, C=8, edges=True),
        megakernel_inputs(5, C=8, N=256, P=2048, K=64),
        megakernel_inputs(5, C=8, N=256, P=2048, K=2048, edges=True),
        megakernel_inputs(5, C=8, N=1713, P=2048, K=512, edges=True),
    ):
        cases.append(("fused_select_cycle_commit", port_kernels.select_cycle_commit_plain, margs, {"k_pods": K}, 6))
        cases.append(("fused_select_schedule_cycle", port_kernels.select_schedule_cycle_plain, margs[:9],
                      {"k_pods": K}, -1))
    for args in (cycle_inputs(5, edges=True), cycle_inputs(5, C=1, N=1713, K=256),
                 cycle_inputs(5, N=1713, K=1024, edges=True)):
        cases.append(("fused_schedule_cycle", port_kernels.schedule_cycle_plain, args, {}, -1))
    for kernel, plain, args, kwargs, stats_idx in cases:
        port_kernels.reset_launches()
        dev_args = [t(a).to(cuda_device) for a in args]
        got = getattr(port_kernels, kernel)(*dev_args, **kwargs, profile=prof)
        torch.cuda.synchronize()
        assert port_kernels.LAUNCHES[kernel] == 1
        want = plain(*dev_args, **kwargs, profile=prof)
        for i, (g, w) in enumerate(zip(got, want)):
            if i == stats_idx:
                assert torch.allclose(g, w, rtol=1e-6, atol=0.0), (kernel, i)
            else:
                assert torch.equal(g, w), (kernel, i)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6])
def test_attempt_draw_kernel_matches_plain_version(cuda_device, seed):
    """The commit-time draw's CUDA kernel equals its plain version bit for
    bit (will_fail and the float32 fail times), on slots that start or
    not, plain or ring, services and finite durations, seeds with the top
    bit set, and pod bases near 2^31; one launch a call."""
    from kubernetriks_tpu_torch.ops import chaos_kernel

    rng = np.random.default_rng(seed)
    for C, P, W in ((3, 40, 30), (64, 2048, 1900), (1, 107136, 107136)):
        start = np.where(rng.random((C, P)) < 0.5, rng.uniform(0.0, 2.0, (C, P)), np.inf).astype(np.float32)
        restarts = rng.integers(0, 6, (C, P)).astype(np.int32)
        dwin = np.where(rng.random((C, P)) < 0.1, -1, rng.integers(0, 500, (C, P))).astype(np.int32)
        doff = rng.uniform(0.0, 10.0, (C, P)).astype(np.float32)
        will_fail = rng.random((C, P)) < 0.3
        pod_base = rng.integers(0, 2**31 - 2 * P, C).astype(np.int32)
        dev_args = [torch.from_numpy(a).to(cuda_device) for a in (start, restarts, dwin, doff, will_fail, pod_base)]
        for fseed, prob in ((7, 0.3), (0xFFFFFFF0, 0.05), (123, 1.0)):
            kw = dict(seed=fseed, plain_width=W, fail_prob=prob, interval=10.0)
            port_kernels.reset_launches()
            got = chaos_kernel.pod_attempt_draw(*dev_args, **kw)
            torch.cuda.synchronize()
            assert port_kernels.LAUNCHES["pod_attempt_draw"] == 1
            want = chaos_kernel.pod_attempt_draw_plain(*dev_args, **kw)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
            assert bool(got[0].any())


@pytest.mark.cuda
def test_fault_run_on_card_matches_cpu(cuda_device):
    """The composed toy with the reference bench's fault block and
    best_fit, through an 8-slot pod window with slot reclaim on both
    sides, on the card (graphs) equals the CPU run, with faults shown and
    the commit-time draw launched."""
    finals = {}
    for where in (cuda_device, "cpu"):
        sim = composed_sim(where, 4, faults=True, pod_window=8, scheduler_profile="best_fit", reclaim=True)
        port_kernels.reset_launches()
        sim.step_until_time(600.0)
        if where != "cpu":
            assert port_kernels.LAUNCHES["pod_attempt_draw"] > 0
            assert port_kernels.LAUNCHES["fused_select_cycle_commit"] == 0  # sorted route below 128
        finals[where] = (state_to_numpy(sim.state), sim.metrics_summary()["counters"])
    assert compare_states(finals["cpu"][0], finals[cuda_device][0]) == []
    counters = finals["cpu"][1]
    assert counters["pod_interruptions"] + counters["pods_failed"] > 0 and counters["node_crashes"] > 0


# --- the window glue: the razor, fast-forward, the conditional move ---------------


def glue_inputs(seed, C=6, N=9, P=40, E=12, G=2):
    """Seeded operands of the window glue kernels (ops/window_kernel.py):
    rows where most pending times are +inf (INF_WIN) and a few are due,
    running, queued and parked pods, a slab with some clusters past its
    end, autoscaler due times and CA counts, and a wake scan's sorted
    operands. Returns a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    inf = 1 << 29

    def sparse_wins(shape, p):
        return np.where(rng.random(shape) < p, rng.integers(0, 30, shape), inf).astype(np.int32)

    packed = np.zeros((C, E, 4), np.int32)
    packed[..., 0] = np.sort(rng.integers(0, 40, (C, E)), axis=1)
    phase = rng.choice([0, 1, 2, 3, 4], size=(C, P), p=[0.2, 0.1, 0.1, 0.4, 0.2]).astype(np.int32)
    V = N + P
    o_valid = np.zeros((C, P), bool)
    for c in range(C):
        o_valid[c, : rng.integers(0, P)] = True
    s_valid = np.zeros((C, V), bool)
    for c in range(C):
        s_valid[c, : rng.integers(0, 12)] = True
    return {
        "cursor": rng.integers(0, E + 2, C).astype(np.int32),
        "packed": packed,
        "create_win": sparse_wins((C, N), 0.05),
        "remove_win": sparse_wins((C, N), 0.05),
        "removal_win": sparse_wins((C, P), 0.02),
        "phase": phase,
        "finish_win": rng.integers(0, 40, (C, P)).astype(np.int32),
        "finish_off": rng.choice([0.0, 2.5, 7.25], size=(C, P)).astype(np.float32),
        "queue_win": rng.integers(0, 40, (C, P)).astype(np.int32),
        "last_flush": rng.integers(0, 20, C).astype(np.int32),
        "ca_next_win": rng.integers(0, 40, C).astype(np.int32),
        "ca_next_off": rng.uniform(0.0, 10.0, C).astype(np.float32),
        "ca_snap_win": np.zeros(C, np.int32),
        "ca_snap_off": rng.uniform(0.0, 9.9, C).astype(np.float32),
        "hpa_next_win": rng.integers(0, 60, C).astype(np.int32),
        "hpa_next_off": rng.uniform(0.0, 10.0, C).astype(np.float32),
        "col_next_win": rng.integers(0, 60, C).astype(np.int32),
        "ca_count": rng.integers(0, 2, (C, G)).astype(np.int32),
        "hpa_int_win": np.full(C, 1, np.int32),
        "hpa_int_off": np.full(C, 5.0, np.float32),
        "ca_period_win": np.full(C, 2, np.int32),
        "ca_period_off": rng.uniform(0.0, 9.9, C).astype(np.float32),
        "o_valid": o_valid,
        "o_cpu": rng.choice([500, 1000, 4000, 9000], size=(C, P)).astype(np.int32),
        "o_ram": rng.choice([1, 2, 4, 8], size=(C, P)).astype(np.int32),
        "s_valid": s_valid,
        "s_is_node": rng.random((C, V)) < 0.3,
        "s_cpu": rng.choice([1000, 4000, 16000], size=(C, V)).astype(np.int32),
        "s_ram": rng.choice([2, 8, 16], size=(C, V)).astype(np.int32),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_glue_kernels_match_plain_versions(cuda_device, seed):
    """Each window glue kernel on the card equals its plain version on the
    same inputs, bit for bit, with one launch counted; the razor's
    predicate where some row is due and where none is, the next window
    with and without the autoscalers and a parked pod, the catch-up over
    spans of 0, 1 and 37 windows, the conditional move's scans."""
    from kubernetriks_tpu_torch.batched import step
    from kubernetriks_tpu_torch.ops import window_kernel as wk

    x = {k: t(v).to(cuda_device) for k, v in glue_inputs(seed).items()}
    C = x["cursor"].shape[0]
    calls = []
    for w in (0, 3, 25):
        W = torch.full((C,), w, dtype=torch.int32, device=cuda_device)
        calls.append(("window_work_due", wk.window_work_due, step.window_work_due_plain, (
            x["cursor"], x["packed"], x["create_win"], x["remove_win"], x["removal_win"], x["phase"],
            x["finish_win"], x["finish_off"], W), {}))
        limit = torch.tensor([w + 50], dtype=torch.int32, device=cuda_device)
        base = (x["cursor"], x["packed"], x["phase"], x["finish_win"], x["create_win"], x["remove_win"],
                x["removal_win"], x["queue_win"], x["last_flush"], W, limit)
        auto = (x["ca_next_win"], x["ca_next_off"], x["ca_snap_win"], x["ca_snap_off"], x["hpa_next_win"])
        kw = {"flush_windows": 3, "interval": 10.0}
        calls.append(("next_window_span", wk.next_window_span, step.next_window_span_plain, base, kw))
        calls.append(("next_window_span", wk.next_window_span, step.next_window_span_plain,
                      base + auto + (x["col_next_win"], x["ca_count"]), kw))
        calls.append(("next_window_span", wk.next_window_span, step.next_window_span_plain,
                      base + auto + (None, x["ca_count"]), kw))
    for lo, hi in ((5, 5), (5, 6), (3, 40)):
        span = torch.tensor([lo, hi], dtype=torch.int32, device=cuda_device)
        head = (span, x["last_flush"], x["finish_win"][:, 0].contiguous())
        pairs = tuple(x[k] for k in ("hpa_next_win", "hpa_next_off", "ca_next_win", "ca_next_off", "hpa_int_win",
                                     "hpa_int_off", "ca_snap_win", "ca_snap_off", "ca_period_win", "ca_period_off"))
        kw = {"interval": 10.0, "flush_interval": 30.0}
        calls.append(("catch_up", wk.catch_up, step.catch_up_plain, head, kw))
        calls.append(("catch_up", wk.catch_up, step.catch_up_plain, head + pairs, kw))
    calls.append(("conditional_wake_scan", wk.conditional_wake_scan, step.wake_scan_plain, tuple(
        x[k] for k in ("o_valid", "o_cpu", "o_ram", "s_valid", "s_is_node", "s_cpu", "s_ram")), {}))
    seen = set()
    for name, kernel, plain, args, kw in calls:
        port_kernels.reset_launches()
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert port_kernels.LAUNCHES[name] == 1
        want = plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert (g is None) == (w is None), name
            if g is not None:
                assert g.dtype == w.dtype and torch.equal(g.cpu().view(-1), w.cpu().view(-1)), name
        seen.add((name, bool(got[0].any()) if got[0].dtype == torch.bool else None))
    assert ("window_work_due", True) in seen and ("conditional_wake_scan", True) in seen


def _sparse_build(device, **kwargs):
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

    return build_batched_from_traces(
        SimulationConfig.from_yaml("sim_name: ff\nseed: 1\nscheduling_cycle_interval: 10.0\n"),
        UniformClusterTrace(6, cpu=16000, ram=32 * 1024**3).convert_to_simulator_events(),
        PoissonWorkloadTrace(rate_per_second=0.02, horizon=3000.0, seed=5, cpu=3000, ram=6 * 1024**3,
                             duration_range=(15.0, 120.0)).convert_to_simulator_events(),
        n_clusters=3, device=device, max_pods_per_cycle=8, **kwargs,
    )


@pytest.mark.cuda
def test_fast_forward_card_matches_cpu_and_every_window(cuda_device):
    """The sparse trace fast-forwarded on the card (graphs, the razor on)
    equals the CPU run fast-forwarded and the card run of every window,
    with the same windows executed and one host read an executed
    window."""
    card = _sparse_build(cuda_device)
    assert card.fast_forward and card.window_razor and card.graphs
    captured = card.precompile_pieces()
    card.step_until_time(4000.0)
    cpu = _sparse_build("cpu")
    cpu.step_until_time(4000.0)
    every = _sparse_build(cuda_device, fast_forward=False)
    every.step_until_time(4000.0)
    stats = card.dispatch_stats
    assert stats["executed_windows"] == cpu.dispatch_stats["executed_windows"] == stats["graph_windows"]
    assert stats["skipped_windows"] > 0 and stats["eager_windows"] == 0 and stats["captures"] == captured
    assert card.host_syncs == stats["executed_windows"]
    got = state_to_numpy(card.state)
    assert compare_states(state_to_numpy(cpu.state), got) == []
    assert compare_states(state_to_numpy(every.state), got) == []


@pytest.mark.cuda
def test_fast_forward_graph_run_equals_eager_run(cuda_device):
    runs = _graph_and_eager(lambda g: _sparse_build(cuda_device, graphs=g), 4000.0)
    (g, _, g_syncs), (e, _, e_syncs) = runs
    assert g.dispatch_stats["skipped_windows"] == e.dispatch_stats["skipped_windows"] > 0
    assert g.dispatch_stats["graph_windows"] == g.dispatch_stats["executed_windows"]
    fg, fe = flatten(g.state), flatten(e.state)
    assert [p for p in fg if not torch.equal(fg[p], fe[p])] == []
    assert g_syncs == e_syncs == g.dispatch_stats["executed_windows"]


@pytest.mark.cuda
def test_conditional_move_card_matches_cpu(cuda_device):
    """The node-removal trace with the conditional move on the card
    (graphs, the razor on): no eager window, no host read, the CPU's
    state; again through the eager executor."""
    finals = []
    for device, graphs in ((cuda_device, True), (cuda_device, False), ("cpu", False)):
        cluster_yaml, workload_yaml = churn_yaml(5)
        sim = build_batched_from_traces(
            SimulationConfig.from_yaml(DELAYS + "enable_unscheduled_pods_conditional_move: true\n"),
            GenericClusterTrace.from_yaml(cluster_yaml).convert_to_simulator_events(),
            GenericWorkloadTrace.from_yaml(workload_yaml).convert_to_simulator_events(),
            n_clusters=4, device=device, max_pods_per_cycle=8, graphs=graphs,
        )
        port_kernels.reset_launches()
        sim.step_until_time(600.0)
        if device != "cpu":
            assert sim.host_syncs == 0 and port_kernels.launch_counts()["conditional_wake_scan"] > 0
            if graphs:
                assert sim.dispatch_stats["eager_windows"] == 0
        finals.append(state_to_numpy(sim.state))
    assert compare_states(finals[2], finals[0]) == [] and compare_states(finals[2], finals[1]) == []


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [1.0, 20.0])
def test_razor_graph_run_equals_eager_run(cuda_device, rate):
    """A gappy trace (two bursts, quiet windows between) on the card: the
    graphs skip gated tails the eager run executes, and end in the same
    state, the eager run launching the skipped tails' kernels more. At 20
    pods/s the pod axis passes one tile of the free kernel (P > 2 048), so
    the gated tail's free kernel runs through its per-stream scratch on
    the conditional bodies' stream."""
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

    def build(graphs):
        bursts = []
        for t0 in (0.0, 600.0):
            w = PoissonWorkloadTrace(rate_per_second=rate, horizon=60.0, seed=int(t0) + 5, cpu=4000,
                                     ram=8 * 1024**3, duration_range=(20.0, 40.0), name_prefix=f"b{int(t0)}")
            bursts += [(tt + t0, ev) for tt, ev in w.convert_to_simulator_events()]
        return build_batched_from_traces(
            SimulationConfig.from_yaml("sim_name: razor\nseed: 1\nscheduling_cycle_interval: 10.0\n"),
            UniformClusterTrace(8, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events(),
            sorted(bursts, key=lambda e: e[0]), n_clusters=2, device=cuda_device, max_pods_per_cycle=16,
            fast_forward=False, graphs=graphs,
        )

    runs = _graph_and_eager(build, 800.0)
    _assert_graph_run_equals_eager_run(runs)
    assert runs[0][0]._executor.skipped_body_launches().get("fused_free_resources", 0) > 0
    assert (runs[0][0].n_pods > 2048) == (rate > 1.0)


def telemetry_inputs(seed, C=6, N=9, P=40, Gp=2, Gn=3, R=16, auto=True):
    """Seeded operands of the telemetry record: phases 0-6, alive nodes,
    the reserve leaves (None without the autoscalers), pod bases, the
    window, ten counters ahead of their snapshot m0, a ring part written
    with its cursor past R (a wrapped slot)."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    head = rng.integers(0, 20, (C, Gp)).astype(i32)
    args = [
        t(rng.integers(0, 7, (C, P)).astype(i32)),
        t(rng.random((C, N)) < 0.6),
        t(head) if auto else None,
        t(head + rng.integers(0, 9, (C, Gp)).astype(i32)) if auto else None,
        t(rng.integers(0, 6, (C, Gn)).astype(i32)) if auto else None,
        t(rng.integers(0, 3 * P, (C,)).astype(i32)),
        t(np.full((C,), 77, i32)),
    ]
    m0 = rng.integers(0, 1000, (10, C)).astype(i32)
    counters = [t(m0[k] + rng.integers(0, 50, (C,)).astype(i32)) for k in range(10)]
    buf = t(rng.integers(-1, 9, (C, R, 12)).astype(i32))
    cursor = t(rng.integers(0, 3 * R, (C,)).astype(i32))
    return args, counters, t(m0), buf, cursor


@pytest.mark.cuda
@pytest.mark.parametrize("seed, shape", [(5, {}), (6, {"C": 3, "N": 301, "P": 4999, "R": 1024}),
                                         (7, {"auto": False})])
def test_telemetry_record_kernel_matches_plain_version(cuda_device, seed, shape):
    """ops/csrc/telemetry_record.cu against step.telemetry_record_plain,
    bit for bit (the row, the cursor and m0, all written in place), at two
    widths and without the autoscalers."""
    from kubernetriks_tpu_torch.batched.step import telemetry_record_plain
    from kubernetriks_tpu_torch.ops.telemetry_kernel import telemetry_record

    args, counters, m0, buf, cursor = telemetry_inputs(seed, **shape)
    P = args[0].shape[1]
    outs = []
    for fn, dev in ((telemetry_record, cuda_device), (telemetry_record_plain, cuda_device), (telemetry_record, "cpu")):
        a = [None if x is None else x.to(dev) for x in args]
        c = [x.to(dev) for x in counters]
        mine = [m0.to(dev).clone(), buf.to(dev).clone(), cursor.to(dev).clone()]
        port_kernels.reset_launches()
        fn(*a, c, *mine, head_bound=2 * P)
        torch.cuda.synchronize()
        assert port_kernels.launch_counts()["telemetry_record"] == (fn is telemetry_record and dev != "cpu")
        outs.append([x.cpu() for x in mine])
    for other in outs[1:]:
        for got, want in zip(outs[0], other):
            assert torch.equal(got, want)
    assert not torch.equal(outs[0][1], buf)  # a row was written


def _but_produced(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k != "feeder_slabs_produced"}


def _telemetry_composed(device, graphs, telemetry=True, **kwargs):
    return composed_sim(device, 8, graphs=graphs, telemetry=telemetry, telemetry_ring=64, reclaim=True, **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("pod_window", [None, 8])
def test_telemetry_graph_run_equals_eager_run_and_cpu(cuda_device, pod_window):
    """With telemetry on, the window graphs (the record in the end graph)
    and the eager executor end in the same state, the ring included, and
    in the CPU's; the drained series of the three are equal and lossless;
    telemetry off launches everything but the record as often, the same
    reads and replays."""
    kw = {} if pod_window is None else {"pod_window": pod_window}
    runs = _graph_and_eager(lambda g: _telemetry_composed(cuda_device, g, **kw), 500.0)
    _assert_graph_run_equals_eager_run(runs, max_syncs=10**6)
    g = runs[0][0]
    assert runs[0][1]["telemetry_record"] == g.windows_run
    cpu = _telemetry_composed("cpu", False, **kw)
    cpu.step_until_time(500.0)
    assert compare_states(state_to_numpy(cpu.state), state_to_numpy(g.state)) == []
    series = [s.telemetry_window_series() for s in (g, runs[1][0], cpu)]
    for wins, data in series[1:]:
        assert np.array_equal(wins, series[0][0]) and np.array_equal(data, series[0][1])
    assert np.array_equal(series[0][0], np.arange(g.next_window_idx))
    off = _graph_and_eager(lambda gr: _telemetry_composed(cuda_device, gr, telemetry=False, **kw), 500.0)[0]
    assert off[1]["telemetry_record"] == 0
    assert {n: k for n, k in off[1].items()} == {**runs[0][1], "telemetry_record": 0}
    # The feeder's production count (pod_window=8 streams on the card)
    # depends on its thread's timing.
    assert _but_produced(off[0].dispatch_stats) == _but_produced(g.dispatch_stats) and off[2] == runs[0][2]


@pytest.mark.cuda
def test_razor_gated_windows_record(cuda_device):
    """A gappy trace on the card with the razor on: the windows whose tail
    the conditional node skips still record (the record sits outside it),
    so the ring has every window, equal to the eager run's and the CPU's
    (razor off)."""
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

    def build(device, graphs):
        bursts = []
        for t0 in (0.0, 600.0):
            w = PoissonWorkloadTrace(rate_per_second=1.0, horizon=60.0, seed=int(t0) + 5, cpu=4000,
                                     ram=8 * 1024**3, duration_range=(20.0, 40.0), name_prefix=f"b{int(t0)}")
            bursts += [(tt + t0, ev) for tt, ev in w.convert_to_simulator_events()]
        return build_batched_from_traces(
            SimulationConfig.from_yaml("sim_name: razor\nseed: 1\nscheduling_cycle_interval: 10.0\n"),
            UniformClusterTrace(8, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events(),
            sorted(bursts, key=lambda e: e[0]), n_clusters=2, device=device, max_pods_per_cycle=16,
            fast_forward=False, graphs=graphs, telemetry=True,
        )

    runs = _graph_and_eager(lambda g: build(cuda_device, g), 800.0)
    _assert_graph_run_equals_eager_run(runs)
    g = runs[0][0]
    assert g.window_razor and any("gate" in k for k in g._executor.graphs)
    assert g._executor.skipped_body_launches().get("fused_free_resources", 0) > 0
    cpu = build("cpu", False)
    cpu.step_until_time(800.0)
    wins, data = g.telemetry_window_series()
    wc, dc = cpu.telemetry_window_series()
    assert np.array_equal(wins, np.arange(g.next_window_idx)) and np.array_equal(wins, wc)
    assert np.array_equal(data, dc)


@pytest.mark.cuda
@pytest.mark.parametrize("depth, segment", [(3, None), (1, 24), (3, 32)])
def test_streamed_run_on_the_card_equals_the_cpu_run(cuda_device, depth, segment):
    """The composed toy through an 8-slot pod window (it slides and grows)
    with the streaming feeder, the card's default: slabs uploaded on the
    copy stream and read in place by their slot's slide graph end in the
    CPU run's state (no feeder there) and the card run's without the
    feeder; an install adds no host read (equal host_syncs, slides and
    growths), and every window replays graphs. (3, None): the default
    width, where a ring of 4W slabs would hold the toy's whole payload, so
    one slab of it a geometry; (1, 24): a one-slab ring whose 24-column
    slabs run ahead at W = 8 and on demand from W = 16 on (24 = W + W/2);
    (3, 32): three slots, each its own slide graph, ahead at W = 8."""
    kw = dict(pod_window=8, stream_depth=depth, stream_segment=segment, reclaim=True)
    runs = {}
    for name, device, stream in (("card", cuda_device, None), ("card, no feeder", cuda_device, False),
                                 ("cpu", "cpu", None)):
        sim = composed_sim(device, 8, stream=stream, **kw)
        sim.step_until_time(600.0)
        runs[name] = sim
    card = runs["card"]
    assert card._stream_on() and not runs["card, no feeder"]._stream_on() and not runs["cpu"]._stream_on()
    stats = card.dispatch_stats
    assert stats["stage_refills"] >= 3 and stats["feeder_slabs_produced"] >= stats["stage_refills"] - stats["grows"]
    assert stats["grows"] > 0 and stats["eager_windows"] == 0 and stats["graph_windows"] == card.windows_run
    want = state_to_numpy(runs["cpu"].state)
    for name in ("card", "card, no feeder"):
        assert compare_states(want, state_to_numpy(runs[name].state)) == [], name
    for name in ("card, no feeder", "cpu"):
        other = runs[name]
        assert other.host_syncs == card.host_syncs
        assert (other.dispatch_stats["slides"], other.dispatch_stats["grows"]) == (stats["slides"], stats["grows"])
    rep = card.telemetry_report()["feeder"]
    assert rep["slabs_produced"] >= 1 and 1 <= rep["ring_capacity"] <= depth and rep["restarts"] == 0
    staging = card.staging_bytes()
    assert 0 < staging["device_peak_bytes"]
    if segment is None:
        assert staging["device_peak_bytes"] <= staging["whole_payload_bytes"]
    card.close()


@pytest.mark.cuda
def test_device_slab_ring_uploads_equal_host_slabs(cuda_device):
    """SlabRing on the card (pinned buffers, copy stream, slots used in
    turn, each refilled after its release event) gives the same slabs as
    the ring on the CPU (plain copies into its slots), over more uploads
    than it has slots."""
    from kubernetriks_tpu_torch.batched.stream import SlabRing, _settle_default

    rng = np.random.default_rng(4)
    C, L = 3, 40
    ring = SlabRing(C, L, True, 2, cuda_device, 10.0, torch.cuda.Stream(cuda_device))
    host = SlabRing(C, L, True, 2, "cpu", 10.0)
    for j in range(5):
        seg = {
            "req_cpu": rng.integers(0, 9000, (C, L)).astype(np.int32),
            "req_ram": rng.integers(0, 9000, (C, L)).astype(np.int32),
            "duration": np.where(rng.random((C, L)) < 0.2, -1.0, rng.uniform(0, 500, (C, L))),
            "create_win": rng.integers(0, 500, (C, L)).astype(np.int32),
            "rank": rng.integers(0, 1 << 30, (C, L)).astype(np.int32),
        }
        slab = ring.upload(seg)
        assert slab.index == j % 2 and slab.stage is ring.slots[j % 2]
        _settle_default(slab)
        want = host.upload(seg)
        for path, leaf in flatten(want.stage).items():
            assert torch.equal(flatten(slab.stage)[path].cpu(), leaf), path
        done = torch.cuda.Event()
        done.record()
        slab.release(done)
        want.release(None)
    assert ring.nbytes() == host.nbytes() == 2 * C * L * 4 * 6 == ring.pinned_nbytes()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6])
def test_attempt_draw_kernel_with_a_seed_vector_matches_plain_version(cuda_device, seed):
    """The commit-time draw with a scenario fleet's per-lane seed vector
    ((C,) uint32 in device memory, every lane keyed on cluster 0) equals its
    plain version bit for bit; a lane's draws depend on its seed alone (two
    lanes with one seed and one pod base draw alike), and a seed written
    into the vector after a capture is the one the graph's replay draws
    with."""
    from kubernetriks_tpu_torch.ops import chaos_kernel

    rng = np.random.default_rng(seed)
    C, P, W = 64, 2048, 1900
    start = np.where(rng.random((C, P)) < 0.5, rng.uniform(0.0, 2.0, (C, P)), np.inf).astype(np.float32)
    restarts = rng.integers(0, 6, (C, P)).astype(np.int32)
    dwin = np.where(rng.random((C, P)) < 0.1, -1, rng.integers(0, 500, (C, P))).astype(np.int32)
    doff = rng.uniform(0.0, 10.0, (C, P)).astype(np.float32)
    will_fail = rng.random((C, P)) < 0.3
    pod_base = rng.integers(0, 2**31 - 2 * P, C).astype(np.int32)
    for a in (start, restarts, dwin, doff, will_fail):
        a[1] = a[0]
    pod_base[1] = pod_base[0]
    seeds = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32)
    seeds[1] = seeds[0]
    seeds[2] = 0xFFFFFFFF
    dev_args = [torch.from_numpy(a).to(cuda_device) for a in (start, restarts, dwin, doff, will_fail, pod_base)]
    vec = torch.from_numpy(seeds).to(cuda_device)
    kw = dict(plain_width=W, fail_prob=0.3, interval=10.0)
    port_kernels.reset_launches()
    got = chaos_kernel.pod_attempt_draw(*dev_args, vec, **kw)
    torch.cuda.synchronize()
    assert port_kernels.LAUNCHES["pod_attempt_draw"] == 1
    want = chaos_kernel.pod_attempt_draw_plain(*dev_args, vec, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(got[0][0], got[0][1]) and bool(got[0].any())
    cpu = chaos_kernel.pod_attempt_draw_plain(*[a.cpu() for a in dev_args], vec.cpu(), **kw)
    assert torch.equal(got[0].cpu(), cpu[0]) and torch.equal(got[1].cpu().view(torch.int32), cpu[1].view(torch.int32))
    # Captured once, replayed after the seeds change: the replay reads the vector.
    out = [None]
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(stream):
        chaos_kernel.pod_attempt_draw(*dev_args, vec, **kw)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        out[0] = chaos_kernel.pod_attempt_draw(*dev_args, vec, **kw)
    vec.copy_(torch.from_numpy(seeds[::-1].copy()))
    graph.replay()
    torch.cuda.synchronize()
    want = chaos_kernel.pod_attempt_draw_plain(*dev_args, vec, **kw)
    assert torch.equal(out[0][0], want[0]) and torch.equal(out[0][1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.cuda
def test_fleet_captures_nothing_after_wave_one(cuda_device):
    """A card fleet (the composed toy with the bench's fault block, 4 lanes,
    3 waves of queries with distinct fault seeds and autoscaler settings)
    captures its pieces at build and nothing in later waves: its scenario
    updates and lane resets write into the captured tensors. Its results
    equal the CPU fleet's."""
    from chip_smoke import FAULTS_YAML, composed_config_yaml, composed_workload_yaml
    from kubernetriks_tpu_torch.batched.fleet import Scenario, ScenarioFleet
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

    cluster = UniformClusterTrace(4, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events()
    plain = PoissonWorkloadTrace(rate_per_second=0.2, horizon=300.0, seed=3, cpu=16000, ram=32 * 1024**3,
                                 duration_range=(30.0, 120.0), name_prefix="plain").convert_to_simulator_events()
    group = GenericWorkloadTrace.from_yaml(composed_workload_yaml(16, (90.0, 90.0, 120.0))).convert_to_simulator_events()
    workload = sorted(plain + group, key=lambda e: e[0])
    config = SimulationConfig.from_yaml(composed_config_yaml(4) + FAULTS_YAML)
    scens = [Scenario(fault_seed=100 + i, hpa_scan_interval=(30.0, 60.0, 90.0)[i % 3], ca_threshold=0.3 + 0.1 * (i % 4))
             for i in range(12)]
    results, captures = {}, {}
    for where in ("cuda", "cpu"):
        fleet = ScenarioFleet(config, cluster, workload, n_lanes=4, horizon=300.0, device=where, max_pods_per_cycle=8,
                              max_ca_pods_per_cycle=64, max_pods_per_scale_down=8, ca_slot_multiplier=4)
        qids = [fleet.submit(s) for s in scens]
        fleet._run_one_wave()
        captures[where] = [fleet.engine.dispatch_stats["captures"]]
        fleet.run()
        captures[where].append(fleet.engine.dispatch_stats["captures"])
        results[where] = [fleet.results[q] for q in qids]
        if where == "cuda":
            assert fleet.engine.graphs and fleet.engine.dispatch_stats["eager_windows"] == 0
        fleet.close()
    assert captures["cuda"][0] > 0 and captures["cuda"][0] == captures["cuda"][1]
    for a, b in zip(results["cuda"], results["cpu"]):
        assert (a.counters, a.hpa_replicas, a.ca_nodes) == (b.counters, b.hpa_replicas, b.ca_nodes)
    assert sum(r.counters["pod_restarts"] for r in results["cuda"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6])
def test_telemetry_record_kernel_with_lane_columns_matches_plain_version(cuda_device, seed):
    """The record with a lane-asynchronous engine's two optional (C,)
    inputs, the global window (column 0) and the active lanes (column 11,
    mixed active and parked), bit for bit against its plain version."""
    from kubernetriks_tpu_torch.batched.step import telemetry_record_plain
    from kubernetriks_tpu_torch.ops.telemetry_kernel import telemetry_record

    args, counters, m0, buf, cursor = telemetry_inputs(seed)
    C, P = args[0].shape
    window = t(np.full((C,), 123, np.int32))
    active = t(np.arange(C) % 3 != 0)
    outs = []
    for fn, dev in ((telemetry_record, cuda_device), (telemetry_record_plain, cuda_device), (telemetry_record, "cpu")):
        a = [None if x is None else x.to(dev) for x in args]
        mine = [m0.to(dev).clone(), buf.to(dev).clone(), cursor.to(dev).clone()]
        fn(*a, [x.to(dev) for x in counters], *mine, head_bound=2 * P, window=window.to(dev), active=active.to(dev))
        torch.cuda.synchronize()
        outs.append([x.cpu() for x in mine])
    for other in outs[1:]:
        for got, want in zip(outs[0], other):
            assert torch.equal(got, want)
    rows = outs[0][1][torch.arange(C), (cursor % buf.shape[1]).long()]
    assert rows[:, 0].tolist() == [123] * C and rows[:, 11].tolist() == active.int().tolist()


def _lane_fleet(device, graphs=None, **kwargs):
    from chip_smoke import FAULTS_YAML, composed_config_yaml, composed_workload_yaml
    from kubernetriks_tpu_torch.batched.fleet import ScenarioFleet
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

    cluster = UniformClusterTrace(4, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events()
    plain = PoissonWorkloadTrace(rate_per_second=0.2, horizon=300.0, seed=3, cpu=16000, ram=32 * 1024**3,
                                 duration_range=(30.0, 120.0), name_prefix="plain").convert_to_simulator_events()
    group = GenericWorkloadTrace.from_yaml(composed_workload_yaml(16, (90.0, 90.0, 120.0))).convert_to_simulator_events()
    config = SimulationConfig.from_yaml(composed_config_yaml(4) + FAULTS_YAML)
    return ScenarioFleet(config, cluster, sorted(plain + group, key=lambda e: e[0]), n_lanes=4, horizon=300.0,
                         device=device, graphs=graphs, max_pods_per_cycle=8, ca_slot_multiplier=4, lane_async=True,
                         span_windows=4, telemetry=True, reclaim=True, **kwargs)


def _lane_scenarios():
    from kubernetriks_tpu_torch.batched.fleet import Scenario

    return [(Scenario(fault_seed=100 + i, hpa_scan_interval=(30.0, 60.0, 90.0)[i % 3]), (300.0, 20.0, 40.0, 20.0)[i % 4])
            for i in range(10)]


@pytest.mark.cuda
def test_lane_async_graph_run_equals_eager_run(cuda_device):
    """A lane-asynchronous fleet on graphs (both freeze variants captured
    at build, nothing after) equals the same fleet eager on the card and
    on the CPU: every result, the final state and the ring with its lane
    column."""
    runs = {}
    for name, where, graphs in (("graphs", "cuda", True), ("eager", "cuda", False), ("cpu", "cpu", None)):
        fleet = _lane_fleet(where, graphs=graphs)
        at_build = fleet.engine.dispatch_stats["captures"]
        qids = [fleet.submit(s, h) for s, h in _lane_scenarios()]
        fleet.run_async()
        if name == "graphs":
            keys = set(fleet.engine._executor.graphs)
            assert ("lanes", "freeze") in keys and ("lanes",) in keys
            stats = fleet.engine.dispatch_stats
            assert stats["captures"] == at_build and stats["eager_windows"] == 0
        runs[name] = ([fleet.results[q] for q in qids], state_to_numpy(fleet.engine.state))
        fleet.close()
    for name in ("eager", "cpu"):
        for a, b in zip(runs["graphs"][0], runs[name][0]):
            assert (a.counters, a.hpa_replicas, a.ca_nodes) == (b.counters, b.hpa_replicas, b.ca_nodes)
        assert compare_states(runs["graphs"][1], runs[name][1]) == [], name
    assert (runs["graphs"][1][".telemetry.buf"][..., 11] == 0).any()


@pytest.mark.cuda
def test_lane_plan_and_reset_write_in_place(cuda_device):
    """set_lane_plan, lane_reset and set_lane_trace keep every tensor the
    captured graphs read (the lane clocks, the state, the slab, the
    executor's buffers) at its address."""
    fleet = _lane_fleet("cuda")
    eng = fleet.engine

    def ptrs():
        return ({k: v.data_ptr() for k, v in flatten(eng._executor.bufs).items() if v.numel()},
                eng.slab.packed.data_ptr())

    before = ptrs()
    eng.set_lane_plan([0, 2], 3, [5, 7])
    eng.lane_reset([1, 2])
    eng.set_lane_trace(1, 0, eng._lane_mux.n_rows // 2)
    eng.step_windows(4)
    assert ptrs() == before
    assert eng._lane_clocks.clock.tolist() == [3, 0, 3, 0] and eng._lane_clocks.horizon.tolist() == [5, 0, 7, 0]
    fleet.close()


@pytest.mark.cuda
@pytest.mark.parametrize("head,kind", [("mlp", "make_sim"), ("attention", "make_sim"), ("mlp", "autoscaled")])
def test_rl_rollout_card_matches_cpu(cuda_device, head, kind):
    """chip_smoke phase 23b at C = 2: greedy and sampled rollouts (the same
    noise) on the card equal the CPU's (actions, valid flags, final state;
    a near-tie flip is reported, any other fails), one update within rtol
    1e-4; the card's rollout launches the event scatter, free and commit
    scatter kernels (and both CA kernels on the autoscaled sim) with their
    plain versions refused."""
    from chip_smoke import rl_autoscaled_sim, rl_bench_sim, rl_card_vs_cpu

    build = rl_bench_sim if kind == "make_sim" else rl_autoscaled_sim
    report = rl_card_vs_cpu(cuda_device, port_kernels, lambda d, **kw: build(d, 2, **kw), head, kind)
    assert report["problems"] == []


@pytest.mark.cuda
def test_rl_train_iteration_on_the_card_is_finite(cuda_device):
    """One PPO iteration a head on the card (the attention head's update
    in chunks): finite losses and params, decisions and placements made."""
    from chip_smoke import rl_bench_sim
    from kubernetriks_tpu_torch.rl.ppo import PPOConfig, PPOTrainer

    sim = rl_bench_sim(cuda_device, 16)
    for head, micro in (("mlp", 0), ("attention", 8)):
        trainer = PPOTrainer(sim, 4, PPOConfig(epochs_per_iteration=2, update_microbatch=micro), policy_kind=head)
        out = trainer.train_iteration()
        assert all(np.isfinite(out[k]) for k in ("policy_loss", "value_loss", "entropy", "mean_reward")), out
        assert out["decisions"] > 0 and out["placements"] > 0
        assert all(bool(torch.isfinite(p).all()) for p in trainer.params.values())
        assert all(p.device.type == "cuda" for p in trainer.params.values())
