"""The port's PPO (kubernetriks_tpu_torch/rl/ppo.py) and learning-proof
harness (rl/evaluate.py) on the CPU, against the JAX package's rl/.

Tolerances:
- compute_gae: rtol 1e-6 (atol 1e-6);
- ppo_loss on one collected batch: the loss and its parts rtol 1e-5, the
  gradients rtol 1e-5 (atol 1e-6 over gradients of order 1e-1);
- one ppo_update from a fresh optimizer against optax.adam: params rtol
  1e-5 (atol 1e-7);
- the microbatched update against the monolithic one: loss and gradients
  rtol 1e-5 (atol 1e-6); params after the step rtol 1e-3, atol 3e-5, the
  reference's own bound (tests/test_rl.py:213-224: Adam's first step
  divides by |g| and so amplifies the summation order's noise on
  near-zero gradients);
- one whole train_iteration with JAX's noise against the reference's:
  decisions and placements exact, params rtol 1e-4 (atol 1e-6);
- on the logit bias alone, whose gradient is zero in exact arithmetic (the
  loss is invariant to a shift of all logits), the updates are checked
  against Adam's bound instead: each side moves at most the learning rate
  a step (SHIFT_INVARIANT);
- the trainer's checkpoint: params, Adam state and generator restored
  exactly, and the next iteration identical;
- eval_policy(bestfit_policy_apply) and eval_kube on make_proof_sim(..., 4):
  counts exact, means rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_reference import jax_state_to_numpy
from test_torch_rl import build_pair, heads, jax_noise

from kubernetriks_tpu.rl import evaluate as jax_evaluate
from kubernetriks_tpu.rl.env import Transition as JaxTransition
from kubernetriks_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from kubernetriks_tpu.rl.ppo import PPOTrainer as JaxPPOTrainer
from kubernetriks_tpu.rl.ppo import compute_gae as jax_gae
from kubernetriks_tpu.rl.ppo import ppo_loss as jax_ppo_loss
from kubernetriks_tpu.rl.ppo import ppo_update as jax_ppo_update

from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.convert import attention_params_from_jax, policy_params_from_flax, state_to_numpy
from kubernetriks_tpu_torch.rl import evaluate
from kubernetriks_tpu_torch.rl.ppo import (
    PPOConfig,
    PPOTrainer,
    adam_init,
    compute_gae,
    ppo_grads,
    ppo_grads_microbatched,
    ppo_loss,
    ppo_update,
)

CONFIG = dict(epochs_per_iteration=2, learning_rate=1e-3, reward_size_weighted=True, shaping_coef=0.2)


def as_port(head, params):
    return policy_params_from_flax(params, "cpu") if head == "mlp" else attention_params_from_jax(params, "cpu")


# The loss is invariant to one shift of all of a row's logits (log_softmax;
# the masked entries are constants), so the logit bias's gradient is zero in
# exact arithmetic and float32 noise in practice. Adam's step divides by |g|:
# on it both sides take a noise-driven step, bounded by the learning rate.
SHIFT_INVARIANT = ("logit.bias", "logit_b")


def assert_params_close(port, ref, rtol, atol, start=None, max_move=0.0):
    """port == ref within rtol / atol; on the shift-invariant logit bias,
    with `start` given, each side within `max_move` of its start."""
    assert sorted(port) == sorted(ref)
    for name in port:
        if start is not None and name in SHIFT_INVARIANT:
            for side in (port[name], ref[name]):
                assert float((side - start[name]).abs().max()) <= max_move, name
            continue
        np.testing.assert_allclose(port[name].detach().numpy(), ref[name].numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


def collected_batch(head="mlp", n_clusters=4):
    """A sampled batch of the port's trainer on make_sim, its GAE, and
    the head's JAX params and apply (the port's params carried from them)."""
    _, psim = build_pair("plain", n_clusters=n_clusters)
    (j_apply, j_params), (p_apply, p_params) = heads(head, psim.n_nodes)
    trainer = PPOTrainer(psim, windows_per_rollout=4, config=PPOConfig(**CONFIG), policy_kind=head, seed=2)
    trainer.params = p_params
    trainer.opt_state = adam_init(p_params)
    final, flat = trainer.collect()
    adv, ret = compute_gae(flat.reward, flat.value, flat.valid, 0.99, 0.95)
    return trainer, flat, adv, ret, (j_apply, j_params)


def to_jax(flat):
    return JaxTransition(*(jnp.asarray(x.numpy()) for x in flat))


def test_gae_matches_reference():
    rng = np.random.default_rng(4)
    T, C = 37, 5
    rewards = rng.normal(size=(T, C)).astype(np.float32)
    values = rng.normal(size=(T, C)).astype(np.float32)
    valid = rng.random((T, C)) < 0.7
    boot = rng.normal(size=C).astype(np.float32)
    for bootstrap in (None, boot):
        j_adv, j_ret = jax_gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(valid), 0.99, 0.95,
                               bootstrap_value=None if bootstrap is None else jnp.asarray(bootstrap))
        p_adv, p_ret = compute_gae(torch.from_numpy(rewards), torch.from_numpy(values), torch.from_numpy(valid),
                                   0.99, 0.95, None if bootstrap is None else torch.from_numpy(bootstrap))
        np.testing.assert_allclose(p_adv.numpy(), np.asarray(j_adv), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(p_ret.numpy(), np.asarray(j_ret), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("head", ["mlp", "attention"])
def test_ppo_loss_and_gradients_match_reference(head):
    trainer, flat, adv, ret, (j_apply, j_params) = collected_batch(head)
    config = PPOConfig(**CONFIG)
    jcfg = JaxPPOConfig(**CONFIG)
    (j_loss, j_aux), j_grads = jax.value_and_grad(jax_ppo_loss, has_aux=True)(
        j_params, j_apply, to_jax(flat), jnp.asarray(adv.numpy()), jnp.asarray(ret.numpy()), jcfg
    )
    p_loss, p_aux, p_grads = ppo_grads(trainer.params, trainer.policy_apply, flat, adv, ret, config)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-5)
    for name in ("policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(p_aux[name]), float(j_aux[name]), rtol=1e-5, atol=1e-7, err_msg=name)
    assert_params_close(p_grads, as_port(head, j_grads), rtol=1e-5, atol=1e-6)
    # The plain loss function agrees with the gradient path's value.
    value, _ = ppo_loss(trainer.params, trainer.policy_apply, flat, adv, ret, config)
    assert float(value) == float(p_loss)


def test_one_update_matches_optax():
    trainer, flat, adv, ret, (j_apply, j_params) = collected_batch("mlp")
    jcfg = JaxPPOConfig(**CONFIG)
    optimizer = optax.adam(jcfg.learning_rate)
    j_new, _, j_loss, _ = jax_ppo_update(
        j_params, optimizer.init(j_params), j_apply, optimizer, to_jax(flat),
        jnp.asarray(adv.numpy()), jnp.asarray(ret.numpy()), jcfg,
    )
    p_new, p_state, p_loss, _ = ppo_update(
        trainer.params, trainer.opt_state, trainer.policy_apply, flat, adv, ret, PPOConfig(**CONFIG)
    )
    assert int(p_state["count"]) == 1
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-5)
    lr = CONFIG["learning_rate"]
    assert_params_close(p_new, as_port("mlp", j_new), rtol=1e-5, atol=1e-7, start=trainer.params, max_move=lr)
    # The inputs are left as they were.
    assert_params_close(trainer.params, as_port("mlp", j_params), rtol=0, atol=0)


@pytest.mark.parametrize("head", ["mlp", "attention"])
def test_microbatched_update_matches_monolithic(head):
    trainer, flat, adv, ret, _ = collected_batch(head, n_clusters=8)
    mono = PPOConfig(**CONFIG)
    micro = PPOConfig(**{**CONFIG, "update_microbatch": 2})
    loss_m, aux_m, grads_m = ppo_grads(trainer.params, trainer.policy_apply, flat, adv, ret, mono)
    loss_c, aux_c, grads_c = ppo_grads_microbatched(trainer.params, trainer.policy_apply, flat, adv, ret, micro)
    np.testing.assert_allclose(float(loss_c), float(loss_m), rtol=1e-5)
    for name in aux_m:
        np.testing.assert_allclose(float(aux_c[name]), float(aux_m[name]), rtol=1e-5, atol=1e-7, err_msg=name)
    for name in grads_m:
        np.testing.assert_allclose(grads_c[name].numpy(), grads_m[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    p_mono, *_ = ppo_update(trainer.params, trainer.opt_state, trainer.policy_apply, flat, adv, ret, mono)
    p_micro, *_ = ppo_update(trainer.params, trainer.opt_state, trainer.policy_apply, flat, adv, ret, micro)
    assert_params_close(p_micro, p_mono, rtol=1e-3, atol=3e-5, start=trainer.params,
                        max_move=CONFIG["learning_rate"])
    with pytest.raises(ValueError, match="must divide"):
        ppo_grads_microbatched(trainer.params, trainer.policy_apply, flat, adv, ret,
                               PPOConfig(**{**CONFIG, "update_microbatch": 3}))


@pytest.mark.parametrize("head", ["mlp", "attention"])
def test_train_iteration_with_reference_noise_matches_reference(head):
    jsim, psim = build_pair("plain")
    jtrainer = JaxPPOTrainer(jsim, windows_per_rollout=4, config=JaxPPOConfig(**CONFIG), policy_kind=head, seed=3)
    ptrainer = PPOTrainer(psim, windows_per_rollout=4, config=PPOConfig(**CONFIG), policy_kind=head, seed=3)
    ptrainer.params = start = as_port(head, jtrainer.params)
    ptrainer.opt_state = adam_init(ptrainer.params)
    _, sub = jax.random.split(jtrainer.rng)  # the key jtrainer.collect rolls out with
    gumbel = torch.from_numpy(jax_noise(sub, 4, psim.max_pods_per_cycle, psim.n_clusters, psim.n_nodes))
    j_out = jtrainer.train_iteration()
    p_out = ptrainer.train_iteration(gumbel=gumbel)
    assert p_out["decisions"] == j_out["decisions"] > 0
    assert p_out["placements"] == j_out["placements"] > 0
    np.testing.assert_allclose(p_out["mean_reward"], j_out["mean_reward"], rtol=1e-5)
    steps = CONFIG["epochs_per_iteration"]
    assert_params_close(ptrainer.params, as_port(head, jtrainer.params), rtol=1e-4, atol=1e-6, start=start,
                        max_move=steps * CONFIG["learning_rate"])
    assert int(ptrainer.opt_state["count"]) == CONFIG["epochs_per_iteration"]


def test_trainer_checkpoint_round_trip(tmp_path):
    _, psim = build_pair("plain")
    trainer = PPOTrainer(psim, windows_per_rollout=4, config=PPOConfig(**CONFIG))
    trainer.train_iteration()
    path = str(tmp_path / "rl_ckpt")
    trainer.save_checkpoint(path)
    _, psim2 = build_pair("plain")
    fresh = PPOTrainer(psim2, windows_per_rollout=4, config=PPOConfig(**CONFIG), seed=999)
    fresh.load_checkpoint(path)
    assert_params_close(fresh.params, trainer.params, rtol=0, atol=0)
    assert int(fresh.opt_state["count"]) == int(trainer.opt_state["count"]) == CONFIG["epochs_per_iteration"]
    for moment in ("mu", "nu"):
        assert_params_close(fresh.opt_state[moment], trainer.opt_state[moment], rtol=0, atol=0)
    assert torch.equal(fresh.generator.get_state(), trainer.generator.get_state())
    # The next iteration is identical: the same noise, the same update.
    assert fresh.train_iteration() == trainer.train_iteration()
    assert_params_close(fresh.params, trainer.params, rtol=0, atol=0)


def test_proof_summaries_match_reference():
    """The learning proof's two baselines on its bimodal scenario at 4
    clusters: best-fit as a greedy policy, and the kube-scheduler path."""
    windows = np.arange(jax_evaluate.PROOF_WINDOWS, dtype=np.int32)
    large = evaluate.PROOF_LARGE["cpu"]
    assert large == jax_evaluate.PROOF_LARGE["cpu"]
    j_bf = jax_evaluate.eval_policy(jax_evaluate.make_proof_sim(91_000, 4), jax_evaluate.bestfit_policy_apply, (),
                                    windows, jax.random.PRNGKey(123), greedy=True, large_cpu=large)
    psim = evaluate.make_proof_sim(91_000, 4, device="cpu")
    p_bf = evaluate.eval_policy(psim, evaluate.bestfit_policy_apply, None, windows, greedy=True, large_cpu=large)
    jsim = jax_evaluate.make_proof_sim(91_000, 4)
    j_kube = jax_evaluate.eval_kube(jsim, windows, large_cpu=large)
    p_kube = evaluate.eval_kube(psim, windows, large_cpu=large)
    assert compare_states(jax_state_to_numpy(jsim.state), state_to_numpy(psim.state)) == []
    means = ("mean_queue_time_s", "mean_reward")
    for j_out, p_out in ((j_bf, p_bf), (j_kube, p_kube)):
        assert sorted(p_out) == sorted(j_out)
        for key, value in j_out.items():
            if key in means:
                np.testing.assert_allclose(p_out[key], value, rtol=1e-6, err_msg=key)
            else:
                assert p_out[key] == value, key
    # The scenario separates the two: best-fit places more large pods.
    assert p_bf["large_placed_frac"] > p_kube["large_placed_frac"]
