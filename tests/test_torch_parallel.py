"""The port's multi-process paths on the CPU: the cluster batch sharded
over a gloo group (BatchedSimulation(mesh=)), ring attention, the sharded
attention policy, and parallel/multihost.py, against the unsharded port
and the JAX package.

Every case spawns its ranks (torch.multiprocessing, start method spawn,
tests/torch_parallel_workers.py) at world size 1, 2 or 4; they join a gloo
group through a FileStore in tmp_path. The JAX side runs here.

- The engine over heterogeneous clusters (chip_smoke.hetero_compiled:
  node counts, arrival rates, seeds and crash chains differ by cluster)
  with the HPA, the CA, slot reclaim, pod and node faults and a sliding
  pod window: at world sizes 2 and 4 the gathered state equals the
  unsharded port engine's and the JAX XLA engine's under compare_states
  (every integer and time leaf exact, float32 `.metrics.` to rtol 1e-6),
  and so do the readouts of the last cluster (a global index). World size
  4 runs fast-forward and the razor, whose quantities reduce over the
  whole batch.
- ring_attention equals JAX's full_attention on the reference's shapes
  (tests/test_parallel.py:34-78), fully masked rows at 0 (rtol 1e-5, atol
  1e-6).
- make_sharded_apply on meshes (2, 2, 1), (1, 2, 2) and (2, 1, 2) equals
  JAX's attention_policy_apply forward (rtol 1e-5, atol 1e-6) and its
  gradients (rtol 5e-3, atol 5e-6, the reference test's).
- initialize_from_env does nothing without a coordinator; put_global and
  to_host round-trip at world size 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_parallel_workers as workers
from test_torch_reference import jax_state_to_numpy

from chip_smoke import hetero_compiled, hetero_sim

from kubernetriks_tpu import chaos as jax_chaos
from kubernetriks_tpu.batched.engine import BatchedSimulation as JaxSimulation
from kubernetriks_tpu.batched.trace_compile import compile_cluster_trace as jax_compile
from kubernetriks_tpu.config import SimulationConfig as JaxConfig
from kubernetriks_tpu.parallel.ring import full_attention
from kubernetriks_tpu.rl.attention_policy import attention_policy_apply, init_attention_policy
from kubernetriks_tpu.rl.policy import NODE_FEATURES
from kubernetriks_tpu.trace.generator import PoissonWorkloadTrace as JaxPoisson, UniformClusterTrace as JaxUniform
from kubernetriks_tpu.trace.generic import GenericWorkloadTrace as JaxGeneric
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.convert import state_to_numpy

JAX_MODS = (JaxConfig, JaxUniform, JaxPoisson, JaxGeneric, jax_compile, jax_chaos)
UNTIL = 600.0
# Pods at 0.05 / s (x 1 to 1.75 by cluster) to 400 s through a 32-slot pod
# window: slides without a growth (each growth recompiles the reference's
# window programs).
TRACE = dict(rate=0.05, horizon=400.0)
# Fast-forward and the razor on: their quantities reduce over the whole
# batch, as the slide's shift does.
ENGINE = dict(n_clusters=8, pod_window=32, reclaim=True, fast_forward=True, window_razor=True)


def _rand_qkv(key, B, H, N, D):
    ks = jax.random.split(key, 4)
    q = jax.random.normal(ks[0], (B, H, N, D), jnp.float32)
    k = jax.random.normal(ks[1], (B, H, N, D), jnp.float32)
    v = jax.random.normal(ks[2], (B, H, N, D), jnp.float32)
    mask = jax.random.bernoulli(ks[3], 0.7, (B, 1, N))
    return q, k, v, mask


def _rand_feats(key, C, N):
    ks = jax.random.split(key, 2)
    feats = jax.random.uniform(ks[0], (C, N, NODE_FEATURES), jnp.float32)
    alive = jax.random.bernoulli(ks[1], 0.8, (C, N)).astype(jnp.float32)
    return feats.at[..., 0].set(alive)


def _ring_cases():
    """The reference test's two cases (tests/test_parallel.py:34-78): a
    random mask, and every key masked."""
    q, k, v, mask = _rand_qkv(jax.random.PRNGKey(1), B=2, H=1, N=8, D=4)
    return {
        "mixed": _rand_qkv(jax.random.PRNGKey(0), B=3, H=2, N=16, D=8),
        "masked": (q, k, v, jnp.zeros_like(mask, bool)),
    }


SHAPES = [(2, 2, 1), (1, 2, 2), (2, 1, 2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn a world size, both started together (each rank joins its
    group once and runs every job in turn): at 2 the sharded engine and
    ring attention, at 4 those and the sharded policy on each mesh shape;
    while they run, the unsharded port engine and the JAX XLA engine run
    here. Returns ({world: its directory}, the port engine, the JAX state)."""
    root = tmp_path_factory.mktemp("parallel")
    ring_in, apply_in = str(root / "ring_in.npz"), str(root / "apply_in.npz")
    workers._save(ring_in, {
        f"{name}:{x}": np.asarray(a) for name, arrs in _ring_cases().items() for x, a in zip("qkvm", arrs)
    })
    params = init_attention_policy(jax.random.PRNGKey(7), hidden=32, heads=4)
    feats = _rand_feats(jax.random.PRNGKey(8), C=4, N=8)
    workers._save(apply_in, {**{k: np.asarray(v) for k, v in params.items()}, "feats": np.asarray(feats)})
    dirs, contexts = {}, []
    for world in (2, 4):
        d = root / f"world{world}"
        d.mkdir()
        jobs = [
            ("engine", (str(d / "state.npz"), dict(ENGINE, **TRACE), UNTIL)),
            ("ring", (ring_in, str(d))),
        ]
        if world == 4:
            jobs += [("sharded_apply", (apply_in, str(d / f"apply{i}.npz"), shape)) for i, shape in enumerate(SHAPES)]
        contexts.append(mp.spawn(workers.suite, args=(world, str(d / "store"), jobs), nprocs=world, join=False))
        dirs[world] = d
    config, traces = hetero_compiled(ENGINE["n_clusters"], mods=JAX_MODS, **TRACE)
    jx = JaxSimulation(
        config, traces, max_pods_per_cycle=8, max_ca_pods_per_cycle=64, max_pods_per_scale_down=8,
        use_pallas=False, **{k: v for k, v in ENGINE.items() if k != "n_clusters"},
    )
    jx.step_until_time(UNTIL)
    port = hetero_sim("cpu", ENGINE["n_clusters"], **{k: v for k, v in ENGINE.items() if k != "n_clusters"}, **TRACE)
    port.step_until_time(UNTIL)
    for ctx in contexts:
        while not ctx.join():
            pass
    return dirs, port, jax_state_to_numpy(jx.state)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_engine_equals_unsharded_and_reference(world, runs):
    spawned, port, reference = runs
    got = workers.load(str(spawned[world] / "state.npz"))
    extra = {k[1:]: got.pop(k) for k in list(got) if k.startswith("~")}
    want = state_to_numpy(port.state)
    assert compare_states(want, got) == []
    assert compare_states(reference, got) == []
    # The run slid and fast-forwarded as the unsharded one did, and each
    # rank held rows no other rank had (the clusters differ).
    slides, grows, executed, skipped, eager = extra["stats"].tolist()
    stats = port.dispatch_stats
    assert (slides, grows, executed, skipped, eager) == (
        stats["slides"], stats["grows"], stats["executed_windows"], stats["skipped_windows"], stats["eager_windows"])
    assert slides > 0 and skipped > 0
    assert extra["rows"].tolist() == [0, ENGINE["n_clusters"] // world]
    assert len({int(n) for n in want[".nodes.cap_cpu"].astype(bool).sum(axis=1)}) > 1
    assert want[".auto.ca_reclaimed"].sum() > 0 and want[".metrics.node_crashes"].sum() > 0
    last = ENGINE["n_clusters"] - 1
    assert int(extra["decisions"]) == port.metrics_summary()["counters"]["scheduling_decisions"]
    metrics = port.cluster_metrics(last)
    assert extra["metrics"].tolist() == [metrics[k] for k in sorted(metrics)]
    assert int(extra["nodes"]) == port.node_count_at(UNTIL - 5.0, last)
    assert int(extra["pods"]) == len(port.pod_view(last))


@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_matches_full_attention(world, runs):
    spawned = runs[0]
    blocks = [workers.load(str(spawned[world] / f"rank{r}.npz")) for r in range(world)]
    for name, (q, k, v, mask) in _ring_cases().items():
        want = np.asarray(full_attention(q, k, v, mask))
        got = np.concatenate([b[name] for b in blocks], axis=-2)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    masked = np.concatenate([b["masked"] for b in blocks], axis=-2)
    assert np.all(np.isfinite(masked)) and np.all(masked == 0.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_attention_policy_matches_forward_and_gradients(shape, runs):
    params = init_attention_policy(jax.random.PRNGKey(7), hidden=32, heads=4)
    feats = _rand_feats(jax.random.PRNGKey(8), C=4, N=8)
    want_logits, want_value = attention_policy_apply(params, feats)

    def loss(p):
        logits, value = attention_policy_apply(p, feats)
        return (jnp.tanh(logits).sum() + (value**2).sum()).astype(jnp.float32)

    want_grads = jax.grad(loss)(params)
    got = workers.load(str(runs[0][4] / f"apply{SHAPES.index(shape)}.npz"))
    np.testing.assert_allclose(got["logits"], np.asarray(want_logits), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["value"], np.asarray(want_value), rtol=1e-5, atol=1e-6)
    for k, g in want_grads.items():
        np.testing.assert_allclose(got[f"grad:{k}"], np.asarray(g), rtol=5e-3, atol=5e-6, err_msg=k)


def test_multihost_round_trip_at_world_size_one(tmp_path):
    out = str(tmp_path / "out.npz")
    mp.spawn(workers.multihost, args=(1, str(tmp_path / "store"), out), nprocs=1, join=True)
    got = workers.load(out)
    assert bool(got["ok"]) and got["rows"].tolist() == [0, 4]


def test_mesh_refusals(tmp_path):
    """A gloo group asked for graphs and a scenario build under a mesh
    raise at build, naming why (in a one-rank group of this process's
    own, torn down after)."""
    import torch.distributed as dist

    from kubernetriks_tpu_torch.parallel.multihost import global_mesh, initialize_from_env

    assert initialize_from_env(f"file://{tmp_path / 'store1'}", 1, 0, backend="gloo")
    try:
        mesh = global_mesh()
        with pytest.raises(ValueError, match="graphs=True needs the card"):
            hetero_sim("cpu", 2, mesh=mesh, graphs=True)
        with pytest.raises(ValueError, match="scenario build"):
            hetero_sim("cpu", 2, mesh=mesh, graphs=False, scenario={"hpa_tolerance": 0.2})
        sim = hetero_sim("cpu", 2, mesh=mesh, graphs=False)
        with pytest.raises(ValueError, match="save_checkpoint is not supported under a mesh"):
            sim.save_checkpoint(str(tmp_path / "ckpt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("until", [150.0, 450.0])
def test_next_window_words_combine_to_the_span(until):
    """Fast-forward's next window under a mesh: every shard's per-cluster
    words (step.next_window_rows_plain), gathered in rank order and
    combined (next_window_combine_plain), give next_window_span_plain's
    span over the whole batch, whichever rows a shard holds (here split in
    halves), with and without parked pods and CA nodes."""
    import torch

    from kubernetriks_tpu_torch.batched import step

    sim = hetero_sim("cpu", 8, fast_forward=False, **TRACE)
    sim.step_until_time(until)
    st, auto, statics = sim.state, sim.state.auto, sim.autoscale_statics
    pods, nodes = st.pods, st.nodes
    W = torch.full((8,), sim.next_window_idx - 1, dtype=torch.int32)
    limit = torch.tensor([sim.next_window_idx + 500], dtype=torch.int32)
    args = (st.event_cursor, sim.slab.packed, pods.phase, pods.finish_time.win, nodes.create_time.win,
            nodes.remove_time.win, pods.removal_time.win, pods.queue_ts.win, st.last_flush_win)
    extra = (auto.ca_next.win, auto.ca_next.off, statics.ca_snap.win, statics.ca_snap.off, auto.hpa_next.win,
             None if auto.col_next is None else auto.col_next.win, auto.ca_count)
    kw = dict(flush_windows=sim.flush_windows, interval=sim.config.scheduling_cycle_interval)
    for ext in ((), extra):
        want = step.next_window_span_plain(*args, W, limit, *ext, **kw)
        halves = []
        for lo, hi in ((0, 4), (4, 8)):
            part = [a[lo:hi] if a is not None else None for a in args + ext]
            halves.append(step.next_window_rows_plain(*part, interval=kw["interval"]))
        got = step.next_window_combine_plain(
            torch.cat(halves), W, limit, flush_windows=kw["flush_windows"], has_auto=bool(ext))
        assert got.tolist() == want.tolist()
