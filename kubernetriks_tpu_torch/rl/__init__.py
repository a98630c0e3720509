"""The RL scheduler loop on the port: policy heads (policy.py,
attention_policy.py), the policy-driven rollout over the window step
(env.py), GAE and PPO with Adam (ppo.py), and the learning-proof harness
(evaluate.py). Port of the JAX package's `rl/`."""
