#!/usr/bin/env python3
"""How the learning proof depends on the policy's initial weights.

    python3 rl_seed_survey.py [--device cpu|cuda] [--seeds 10] [--train SEED] [--iterations 16]
        [--init port|reference]

For seeds 0..N-1, the MLP's initial weights of the port's trainer
(PPOTrainer(seed=s): a torch.Generator) and of the reference's
(rl/reference_init.py: the JAX package's PPOTrainer(seed=s)), each run
greedily over the proof's held-out clusters (rl/evaluate.py, 32 clusters,
48 windows): park decisions, mean queue time and large pods placed a
cluster, beside best-fit's. With --train SEED, the proof's training
(chip_smoke.rl_proof's settings) from that seed's `--init` weights, the
greedy summary every 4 iterations. Prints one JSON line a result.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

KEYS = ("park_decisions_per_cluster", "mean_queue_time_s", "large_placed_frac")


def main() -> None:
    from kubernetriks_tpu_torch.convert import policy_params_from_flax
    from kubernetriks_tpu_torch.rl import evaluate
    from kubernetriks_tpu_torch.rl.policy import init_policy, mlp_apply
    from kubernetriks_tpu_torch.rl.ppo import PPOConfig, PPOTrainer, adam_init
    from kubernetriks_tpu_torch.rl.reference_init import reference_mlp_init

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--train", type=int, default=None)
    ap.add_argument("--iterations", type=int, default=16)
    ap.add_argument("--init", choices=("port", "reference"), default="port")
    args = ap.parse_args()
    dev = torch.device(args.device)
    windows = np.arange(evaluate.PROOF_WINDOWS)
    heldout = evaluate.make_proof_sim(91_000, 32, device=dev)
    policy, _ = init_policy(evaluate.PROOF_N_NODES, device=dev)
    apply = mlp_apply(policy)

    def greedy(apply_fn, params):
        out = evaluate.eval_policy(heldout, apply_fn, params, windows, greedy=True, large_cpu=evaluate.PROOF_LARGE["cpu"])
        return {k: out[k] for k in KEYS}

    def weights(init: str, seed: int):
        if init == "reference":
            return policy_params_from_flax(reference_mlp_init(seed), dev)
        return init_policy(evaluate.PROOF_N_NODES, generator=torch.Generator().manual_seed(seed), device=dev)[1]

    print(json.dumps({"bestfit": greedy(evaluate.bestfit_policy_apply, None)}), flush=True)
    for seed in range(args.seeds):
        print(json.dumps({"seed": seed, **{init: greedy(apply, weights(init, seed)) for init in ("port", "reference")}}),
              flush=True)
    if args.train is None:
        return
    trainer = PPOTrainer(
        evaluate.make_proof_sim(11_000, 32, device=dev), evaluate.PROOF_WINDOWS,
        PPOConfig(learning_rate=3e-4, gamma=0.995, gae_lambda=0.97, epochs_per_iteration=4,
                  reward_size_weighted=True, shaping_coef=0.2),
        seed=args.train,
    )
    trainer.params = weights(args.init, args.train)
    trainer.opt_state = adam_init(trainer.params)
    for it in range(1, args.iterations + 1):
        result = trainer.train_iteration()
        if it % 4 == 0 or it == args.iterations:
            print(json.dumps({"train": args.train, "init": args.init, "iteration": it,
                              "mean_reward": result["mean_reward"], **greedy(apply, trainer.params)}), flush=True)


if __name__ == "__main__":
    main()
