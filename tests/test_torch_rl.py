"""The port's RL environment and policy heads (kubernetriks_tpu_torch/rl/,
parallel/ring.py) on the CPU, against the JAX package's rl/.

Inputs come from seeded numpy, or from the JAX init carried across with
convert.policy_params_from_flax / attention_params_from_jax. Tolerances:
- policy forwards (MLP and attention, (4, 8, 6) and (3, 4, 8, 6)): rtol
  1e-5, atol 1e-6; the attention head's gradients: rtol 1e-4 (atol 1e-5);
- full_attention on rows with no valid key: exactly 0;
- featurize and bestfit_logits_from_obs: exact;
- rl/reference_init.py: JAX's threefry keys, split, fold_in, random bits and
  uniform draws exact; the reference trainer's initial MLP weights
  (flax's lecun-normal draws) within rtol 1e-6, atol 1e-7 (float32 erf_inv
  from float64);
- rollouts (test_rl.py's make_sim shape, C 4, N 8, 8 windows, K 8; and its
  autoscaled sim with CA slot reclaim armed): the final state equal under
  compare_states (every leaf exact, float32 estimators within rtol 1e-6),
  action, valid and obs exact, value, log_prob and reward within rtol 1e-5
  (atol 1e-6). The sampled rollouts take JAX's own Gumbel noise, rebuilt
  from the reference's key sequence (a split a window in rollout, a split
  a decision in policy_cycle, then jax.random.gumbel(sub, (C, N))).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import jax_state_to_numpy

from kubernetriks_tpu.batched.engine import build_batched_from_traces as jax_build
from kubernetriks_tpu.batched.pipeline import bestfit_logits_from_obs as jax_bestfit
from kubernetriks_tpu.config import SimulationConfig as JaxConfig
from kubernetriks_tpu.parallel.ring import full_attention as jax_full_attention
from kubernetriks_tpu.rl import attention_policy as jax_attention
from kubernetriks_tpu.rl.env import featurize as jax_featurize
from kubernetriks_tpu.rl.env import rollout as jax_rollout
from kubernetriks_tpu.rl.policy import init_policy as jax_init_policy
from kubernetriks_tpu.trace.generator import PoissonWorkloadTrace as JaxPoisson
from kubernetriks_tpu.trace.generator import UniformClusterTrace as JaxUniform

from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces as port_build
from kubernetriks_tpu_torch.batched.pipeline import bestfit_logits_from_obs
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.config import SimulationConfig as PortConfig
from kubernetriks_tpu_torch.convert import attention_params_from_jax, policy_params_from_flax, state_to_numpy
from kubernetriks_tpu_torch.parallel.ring import full_attention, ring_attention
from kubernetriks_tpu_torch.rl import attention_policy as port_attention
from kubernetriks_tpu_torch.rl.env import featurize, rollout
from kubernetriks_tpu_torch.rl.policy import NODE_FEATURES, init_policy, mlp_apply
from kubernetriks_tpu_torch.rl import reference_init
from kubernetriks_tpu_torch.rl.ppo import PPOTrainer
from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace as PortPoisson
from kubernetriks_tpu_torch.trace.generator import UniformClusterTrace as PortUniform

RL_CONFIG = "sim_name: rl\nseed: 1\nscheduling_cycle_interval: 10.0"
# tests/test_rl.py make_autoscaled_sim's config.
AUTOSCALED_CONFIG = """
sim_name: rl_autoscaled
seed: 1
scheduling_cycle_interval: 10.0
as_to_ps_network_delay: 0.050
ps_to_sched_network_delay: 0.010
sched_to_as_network_delay: 0.020
as_to_node_network_delay: 0.150
as_to_ca_network_delay: 0.30
as_to_hpa_network_delay: 0.40
cluster_autoscaler:
  enabled: true
  scan_interval: 10.0
  max_node_count: 6
  node_groups:
  - node_template:
      metadata:
        name: ca_node
      status:
        capacity:
          cpu: 16000
          ram: 34359738368
"""
WINDOWS = 8


def build_pair(kind: str, n_clusters: int = 4, **kwargs):
    """(JAX sim, port sim on the CPU) of test_rl.py's make_sim ("plain") or
    make_autoscaled_sim ("autoscaled") on the same traces."""
    if kind == "plain":
        config, nodes, node_cpu, pod_cpu = RL_CONFIG, 8, 16000, 4000
    else:
        config, nodes, node_cpu, pod_cpu = AUTOSCALED_CONFIG, 2, 8000, 6000
    pods = dict(rate_per_second=0.5, horizon=200.0, seed=7, cpu=pod_cpu, ram=pod_cpu // 1000 * 2 * 1024**3,
                duration_range=(20.0, 60.0))
    sims = []
    for build, cfg, uniform, poisson, extra in (
        (jax_build, JaxConfig, JaxUniform, JaxPoisson, {}),
        (port_build, PortConfig, PortUniform, PortPoisson, {"device": "cpu"}),
    ):
        sims.append(build(
            cfg.from_yaml(config),
            uniform(nodes, cpu=node_cpu, ram=node_cpu // 1000 * 2 * 1024**3).convert_to_simulator_events(),
            poisson(**pods).convert_to_simulator_events(),
            n_clusters=n_clusters, max_pods_per_cycle=8, **extra, **kwargs,
        ))
    return sims


def heads(kind: str, n_nodes: int):
    """((JAX apply, JAX params), (port apply, port params)) of one head,
    the JAX init carried across."""
    if kind == "mlp":
        policy, params = jax_init_policy(jax.random.PRNGKey(0), n_nodes)
        port_policy, _ = init_policy(n_nodes, device="cpu")
        return (policy.apply, params), (mlp_apply(port_policy), policy_params_from_flax(params, "cpu"))
    params = jax_attention.init_attention_policy(jax.random.PRNGKey(1))
    return (
        (jax_attention.attention_policy_apply, params),
        (port_attention.attention_policy_apply, attention_params_from_jax(params, "cpu")),
    )


def jax_noise(key, n_windows: int, K: int, C: int, N: int) -> np.ndarray:
    """The Gumbel draws of the reference's sampled rollout from `key`:
    rollout splits its carry once a window (env.py:259), policy_cycle its
    own once a decision (env.py:143), and jax.random.categorical adds
    gumbel(sub, (C, N)) to the logits."""
    out = np.zeros((n_windows, K, C, N), np.float32)
    rng = key
    for w in range(n_windows):
        rng, sub = jax.random.split(rng)
        for j in range(K):
            sub, draw = jax.random.split(sub)
            out[w, j] = np.asarray(jax.random.gumbel(draw, (C, N), jnp.float32))
    return out


def random_obs(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0.0, 1.0, size=shape + (NODE_FEATURES,)).astype(np.float32)
    obs[..., 0] = rng.random(shape) < 0.8
    obs[..., 1] = rng.random(shape) < 0.6
    return obs


def assert_transitions(jt, pt):
    for name in ("action", "valid", "obs"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)), getattr(pt, name).numpy(), err_msg=name)
    for name in ("value", "log_prob", "reward"):
        np.testing.assert_allclose(
            getattr(pt, name).numpy(), np.asarray(getattr(jt, name)), rtol=1e-5, atol=1e-6, err_msg=name
        )


def run_both(jsim, psim, head: str, greedy: bool, key=jax.random.PRNGKey(5)):
    (j_apply, j_params), (p_apply, p_params) = heads(head, psim.n_nodes)
    jfinal, jt = jax_rollout(
        jsim.state, jsim.slab, jnp.arange(WINDOWS, dtype=jnp.int32), jsim.consts, j_params, key, j_apply,
        jsim.max_events_per_window, jsim.max_pods_per_cycle, greedy=greedy,
        conditional_move=jsim.conditional_move, autoscale_statics=jsim.autoscale_statics,
        max_ca_pods_per_cycle=jsim.max_ca_pods_per_cycle, max_pods_per_scale_down=jsim.max_pods_per_scale_down,
    )
    gumbel = None
    if not greedy:
        gumbel = torch.from_numpy(jax_noise(key, WINDOWS, psim.max_pods_per_cycle, psim.n_clusters, psim.n_nodes))
    pfinal, pt = rollout(psim, psim.state, psim.initial_window_plans(WINDOWS), p_params, p_apply,
                         gumbel=gumbel, greedy=greedy)
    assert compare_states(jax_state_to_numpy(jfinal), state_to_numpy(pfinal)) == []
    assert_transitions(jt, pt)
    return jfinal, jt, pt


@pytest.mark.parametrize("shape", [(4, 8), (3, 4, 8)])
@pytest.mark.parametrize("head", ["mlp", "attention"])
def test_policy_forward_matches_reference(head, shape):
    (j_apply, j_params), (p_apply, p_params) = heads(head, shape[-1])
    obs = random_obs(shape, seed=len(shape))
    j_logits, j_value = j_apply(j_params, jnp.asarray(obs))
    p_logits, p_value = p_apply(p_params, torch.from_numpy(obs))
    assert p_logits.shape == shape and p_value.shape == shape[:-1]
    np.testing.assert_allclose(p_logits.detach().numpy(), np.asarray(j_logits), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p_value.detach().numpy(), np.asarray(j_value), rtol=1e-5, atol=1e-6)


def test_attention_gradients_match_reference():
    (_, j_params), (_, p_params) = heads("attention", 8)
    obs = random_obs((3, 4, 8), seed=7)
    rng = np.random.default_rng(8)
    wl = rng.normal(size=(3, 4, 8)).astype(np.float32)
    wv = rng.normal(size=(3, 4)).astype(np.float32)

    def j_loss(params):
        logits, value = jax_attention.attention_policy_apply(params, jnp.asarray(obs))
        return (logits * wl).sum() + (value * wv).sum()

    j_grads = jax.grad(j_loss)(j_params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p_params.items()}
    logits, value = port_attention.attention_policy_apply(leaves, torch.from_numpy(obs))
    ((logits * torch.from_numpy(wl)).sum() + (value * torch.from_numpy(wv)).sum()).backward()
    assert sorted(leaves) == sorted(j_grads) == sorted(port_attention.PARAM_NAMES)
    for name, leaf in leaves.items():
        # atol: float32 sums of ~10^3 terms of order 1 cancel to ~1e-6.
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(j_grads[name]), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_full_attention_gives_zero_on_rows_without_a_valid_key(tmp_path):
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 4, 8, 16)).astype(np.float32) for _ in range(3))
    mask = rng.random((2, 1, 8)) < 0.5
    mask[1] = False  # every query of batch row 1 has no valid key
    out = full_attention(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask))
    assert torch.isfinite(out).all()
    assert (out[1] == 0).all()
    ref = jax_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # The ring form on a one-rank gloo group of this process (its shards at
    # world sizes 2 and 4: tests/test_torch_parallel.py) gives the same
    # rows, the empty ones 0.
    import torch.distributed as dist

    from kubernetriks_tpu_torch.parallel.multihost import initialize_from_env

    assert initialize_from_env(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo")
    try:
        ring = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask))
    finally:
        dist.destroy_process_group()
    assert (ring[1] == 0).all()
    np.testing.assert_allclose(ring.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_featurize_and_bestfit_logits_are_exact():
    rng = np.random.default_rng(11)
    C, N = 6, 8
    cap_cpu = rng.choice([0, 4000, 16000], size=(C, N)).astype(np.int32)
    cap_ram = rng.choice([0, 8192, 32768], size=(C, N)).astype(np.int32)
    alloc_cpu = (cap_cpu * rng.uniform(0, 1, size=(C, N))).astype(np.int32)
    alloc_ram = (cap_ram * rng.uniform(0, 1, size=(C, N))).astype(np.int32)
    alive = rng.random((C, N)) < 0.8
    req_cpu = rng.choice([1000, 2000, 4000, 12000], size=C).astype(np.int32)
    req_ram = rng.choice([1024, 4096, 8192], size=C).astype(np.int32)
    args = (alive, alloc_cpu, alloc_ram, cap_cpu, cap_ram, req_cpu, req_ram)
    j_obs = np.asarray(jax_featurize(*(jnp.asarray(a) for a in args)))
    p_obs = featurize(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(p_obs, j_obs)
    np.testing.assert_array_equal(
        bestfit_logits_from_obs(torch.from_numpy(p_obs)).numpy(), np.asarray(jax_bestfit(jnp.asarray(j_obs)))
    )


@pytest.mark.parametrize("head", ["mlp", "attention"])
def test_greedy_rollout_matches_reference(head):
    jsim, psim = build_pair("plain")
    _, _, pt = run_both(jsim, psim, head, greedy=True)
    assert pt.action.shape == (WINDOWS, psim.max_pods_per_cycle, psim.n_clusters)
    assert pt.valid.any()


def test_sampled_rollout_with_reference_noise_matches_reference():
    jsim, psim = build_pair("plain")
    _, jt, pt = run_both(jsim, psim, "mlp", greedy=False)
    # The noise moved decisions off the greedy choice somewhere.
    (_, _), (p_apply, p_params) = heads("mlp", psim.n_nodes)
    _, greedy = rollout(psim, psim.state, psim.initial_window_plans(WINDOWS), p_params, p_apply, greedy=True)
    assert not torch.equal(greedy.action, pt.action)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_autoscaled_rollout_with_reclaim_matches_reference(greedy):
    """The CA scales nodes up inside the rollout and the policy places on
    them; reclaim armed on both sides (the reference's rollout: no
    compaction pass, the CA pass stamps allocation indices)."""
    jsim, psim = build_pair("autoscaled", reclaim=True)
    assert psim.reclaim and psim.state.auto.ca_alloc is not None
    jfinal, _, pt = run_both(jsim, psim, "mlp", greedy=greedy)
    assert int(np.asarray(jfinal.metrics.scaled_up_nodes).sum()) > 0
    placed = pt.valid & (pt.obs[..., 1] > 0).any(dim=-1)
    assert (pt.action[placed] >= 2).any(), "no placement on a scaled-up node"


def test_collect_leaves_the_sim_state_and_its_plans_unchanged():
    _, psim = build_pair("plain")
    before = state_to_numpy(psim.state)
    psim.step_until_time(30.0)
    stepped = state_to_numpy(psim.state)
    cursor, window = psim._cursor.copy(), psim.next_window_idx
    with pytest.raises(ValueError, match="already stepped"):
        PPOTrainer(psim, windows_per_rollout=4)
    _, fresh = build_pair("plain")
    trainer = PPOTrainer(fresh, windows_per_rollout=WINDOWS)
    _, flat = trainer.collect()
    assert flat.action.shape == (WINDOWS * fresh.max_pods_per_cycle, fresh.n_clusters)
    assert compare_states(before, state_to_numpy(fresh.state)) == []
    assert compare_states(before, state_to_numpy(trainer.initial_state)) == []
    # The plans of the build state leave a stepped engine's mirrors alone.
    plans = psim.initial_window_plans(WINDOWS)
    assert plans == trainer.plans
    assert np.array_equal(psim._cursor, cursor) and psim.next_window_idx == window
    assert compare_states(stepped, state_to_numpy(psim.state)) == []


def test_trainer_refuses_a_sliding_pod_window():
    _, psim = build_pair("plain", pod_window=64)
    with pytest.raises(ValueError, match="sliding pod window"):
        PPOTrainer(psim)


def test_reference_init_reproduces_jax_and_flax():
    key = jax.random.PRNGKey(7)
    ours = reference_init.prng_key(7)
    assert np.array_equal(np.asarray(key), ours)
    assert np.array_equal(np.asarray(jax.random.split(key)), reference_init.split(ours))
    assert np.array_equal(np.asarray(jax.random.fold_in(key, 12345)), reference_init.fold_in(ours, 12345))
    assert np.array_equal(np.asarray(jax.random.bits(key, (3, 5), jnp.uint32)), reference_init.random_bits(ours, (3, 5)))
    assert np.array_equal(
        np.asarray(jax.random.uniform(key, (4, 6), jnp.float32, -0.3, 0.9)),
        reference_init.uniform(ours, (4, 6), np.float32(-0.3), np.float32(0.9)),
    )
    for seed in (0, 3):
        _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
        _, flax_params = jax_init_policy(init_rng, 16)
        ours = reference_init.reference_mlp_init(seed)
        for layer, leaves in flax_params["params"].items():
            for name, value in leaves.items():
                np.testing.assert_allclose(ours["params"][layer][name], np.asarray(value), rtol=1e-6, atol=1e-7,
                                           err_msg=f"{seed} {layer} {name}")
        # Carried into the module, the two heads agree on random inputs.
        obs = random_obs((4, 16), seed=seed)
        policy, _ = init_policy(16, device="cpu")
        p_logits, _ = mlp_apply(policy)(policy_params_from_flax(ours, "cpu"), torch.from_numpy(obs))
        j_logits, _ = jax_init_policy(init_rng, 16)[0].apply(flax_params, jnp.asarray(obs))
        np.testing.assert_allclose(p_logits.detach().numpy(), np.asarray(j_logits), rtol=1e-5, atol=1e-6)
