"""Process bodies for tests/test_torch_parallel.py: each is spawned (torch
multiprocessing, start method spawn) once a rank, joins a gloo group
through a FileStore under the test's tmp_path (no TCP port, so parallel
test workers never collide), runs its part and writes what it got to an
.npz file the test compares. No jax import: the JAX side runs in the test
process."""

import os

import numpy as np
import torch


def _join(rank: int, world: int, store: str) -> None:
    from kubernetriks_tpu_torch.parallel.multihost import initialize_from_env

    # A collective that waits 120 s for a peer raises: ranks whose windows
    # diverge fail the test instead of hanging it.
    assert initialize_from_env(f"file://{store}", world, rank, backend="gloo", timeout_s=120.0)


def _save(path: str, tree: dict) -> None:
    np.savez(path, **{k.replace(".", "|"): np.asarray(v) for k, v in tree.items()})


def load(path: str) -> dict:
    return {k.replace("|", "."): v for k, v in np.load(path).items()}


def _leave() -> None:
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def suite(rank, world, store, jobs):
    """Join the group once, then run each (job name, arguments) in turn
    (every rank the same list)."""
    _join(rank, world, store)
    for name, args in jobs:
        globals()[name](rank, world, *args)
    _leave()


def engine(rank, world, out, kw, until):
    """hetero_sim's clusters sharded over the world's ranks (graphs off:
    gloo); rank 0 writes the gathered state, the dispatch counters and the
    readouts of the last cluster."""
    from chip_smoke import hetero_sim

    from kubernetriks_tpu_torch.parallel.multihost import global_mesh

    kw = dict(kw)
    sim = hetero_sim("cpu", kw.pop("n_clusters"), mesh=global_mesh(), graphs=False, **kw)
    sim.step_until_time(until)
    state = sim.host_state()
    summary = sim.metrics_summary()
    last = sim.n_clusters - 1
    view = sim.pod_view(last)
    metrics = sim.cluster_metrics(last)
    nodes = sim.node_count_at(until - 5.0, last)
    if rank == 0:
        extra = {
            "stats": np.array([sim.dispatch_stats[k] for k in ("slides", "grows", "executed_windows",
                                                                "skipped_windows", "eager_windows")]),
            "rows": np.array(sim._rows), "decisions": np.array(summary["counters"]["scheduling_decisions"]),
            "metrics": np.array([metrics[k] for k in sorted(metrics)]), "nodes": np.array(nodes),
            "pods": np.array(len(view)),
        }
        _save(out, {**state, **{"~" + k: v for k, v in extra.items()}})


def ring(rank, world, inp, out):
    """ring_attention on this rank's block of the node axis of every case
    in `inp`; each rank writes its output blocks to out/rank{r}.npz."""
    from kubernetriks_tpu_torch.parallel.ring import ring_attention

    cases = load(inp)
    got = {}
    for name in sorted({k.split(":")[0] for k in cases}):
        q, k, v, m = (torch.from_numpy(cases[f"{name}:{x}"]) for x in "qkvm")
        n = q.shape[-2] // world
        blk = slice(rank * n, (rank + 1) * n)
        got[name] = ring_attention(q[..., blk, :], k[..., blk, :], v[..., blk, :], m[..., blk]).numpy()
    _save(os.path.join(out, f"rank{rank}.npz"), got)


def sharded_apply(rank, world, inp, out, shape):
    """make_sharded_apply on a (data, seq, model) mesh of `shape`: the
    forward and the gradient of tanh(logits).sum() + (value ** 2).sum()
    with respect to every parameter; rank 0 writes them."""
    from torch.distributed.device_mesh import DeviceMesh

    from kubernetriks_tpu_torch.rl.attention_policy import PARAM_NAMES, make_sharded_apply

    data = load(inp)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape), mesh_dim_names=("data", "seq", "model"))
    params = {k: torch.from_numpy(data[k]).requires_grad_(True) for k in PARAM_NAMES}
    apply = make_sharded_apply(mesh)
    logits, value = apply(params, torch.from_numpy(data["feats"]))
    loss = torch.tanh(logits).sum() + (value**2).sum()
    grads = torch.autograd.grad(loss, [params[k] for k in PARAM_NAMES])
    if rank == 0:
        _save(out, {"logits": logits.detach().numpy(), "value": value.detach().numpy(),
                    **{f"grad:{k}": g.numpy() for k, g in zip(PARAM_NAMES, grads)}})


def multihost(rank, world, store, out):
    """initialize_from_env without a coordinator does nothing; with one,
    put_global and to_host round-trip a tree at this world size."""
    import torch.distributed as dist

    from kubernetriks_tpu_torch.parallel import multihost as mh

    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        os.environ.pop(name, None)
    quiet = mh.initialize_from_env()
    assert not dist.is_initialized()
    _join(rank, world, store)
    mesh = mh.global_mesh()
    group = mh.mesh_group(mesh)
    C = 4 * world
    tree = {"a": np.arange(C * 3, dtype=np.int32).reshape(C, 3), "b": np.linspace(0, 1, C).astype(np.float32),
            "scalar": np.float32(2.5)}
    mine = mh.put_global(tree, group, C)
    lo, hi = mh.row_range(C, group)
    back = {k: mh.to_host(mine[k], group) for k in ("a", "b")}
    ok = (quiet is False and mine["a"].shape[0] == hi - lo and np.array_equal(back["a"], tree["a"])
          and np.array_equal(back["b"], tree["b"]) and float(mine["scalar"]) == 2.5
          and mh.is_cross_process(mesh) == (world > 1) and mh.initialize_from_env() == (world > 1))
    if rank == 0:
        _save(out, {"ok": np.array(ok), "rows": np.array([lo, hi])})
    _leave()
