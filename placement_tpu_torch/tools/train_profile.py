"""Phase split of one PPO training iteration of the port (counterpart of
the JAX package's ``tools/train_profile.py``).

One iteration is a rollout (``--num-envs`` boards x ``--unroll-length``
steps through the pooled engine, the policy sampling) with GAE, then
``num_sgd_iter`` epochs of ``train_batch / 128`` minibatch Adam steps
(RLlib's defaults, ``agent/ppo.py``). This tool times:

  * rollout+GAE alone;
  * with ``--components``, the rollout's pieces apart, each as
    ``--unroll-length`` calls: ``core.observe``, the policy's forward and
    sampling on a fixed observation, and the pooled env step with the
    random policy;
  * the whole ``train_step`` at ``num_sgd_iter`` 1, 10 and 30, so that the
    cost of an epoch is the slope;
  * what the JAX tool cannot give: one minibatch step (train forward,
    loss, backward, Adam) under ``torch.profiler``: its kernel launches,
    the device's busy ms and the wall ms (on a card).

    python -m placement_tpu_torch.tools.train_profile --type rectangle_pin

Each phase: one call timed alone (``*_first_call_s``), then as many calls
as ``--budget-s`` allows at that call's pace, 1 to 10 (as the JAX tool
times its iterations), in one window that ends in a read of a scalar that
depends on every call (the KL coefficient or the advantages' sum). The
model's weights are drawn from ``--seed`` with Flax's initializers.
Prints one JSON line (the JAX artifact's keys, the device and the card's
name and power limit, ``reduced``) and writes it to ``--out`` if given.
"""

import argparse
import dataclasses
from typing import Dict

import torch

from placement_tpu_torch.agent.policy import Policy
from placement_tpu_torch.agent.ppo import PPOConfig, PPOLearner
from placement_tpu_torch.agent.random_policy import random_action
from placement_tpu_torch.env import core, pooled
from placement_tpu_torch.tools import bench_matrix
from placement_tpu_torch.tools._timing import (
    finish, profile_once, reduced, time_calls)
from placement_tpu_torch.utils.config import MODEL_TYPES, load_experiment

#: the JAX tool's defaults (``tools/train_profile.py:86-89``)
JAX_DEFAULTS = {"num_envs": 128, "unroll_length": 32}
EPOCHS = (1, 10, 30)
MIN_CALLS, MAX_CALLS = 1, 10


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--type", default="rectangle_pin",
                   choices=sorted(MODEL_TYPES))
    p.add_argument("--num-envs", type=int, default=JAX_DEFAULTS["num_envs"])
    p.add_argument("--unroll-length", type=int,
                   default=JAX_DEFAULTS["unroll_length"])
    p.add_argument("--components", action="store_true",
                   help="also time the rollout's pieces (observe / policy "
                        "forward / env step) apart")
    p.add_argument("--budget-s", type=float, default=30.0,
                   help="seconds of timed calls a phase, about")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="the card (default; raises without one) or 'cpu'")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    device = core.check_device(args.device, "train_profile")
    env_params, model_cfg, _ = load_experiment(args.type)
    policy = Policy(env_params, model_cfg, device)
    base = PPOConfig(num_envs=args.num_envs,
                     unroll_length=args.unroll_length)
    phases: Dict = {}
    result = {"type": args.type, "num_envs": args.num_envs,
              "unroll_length": args.unroll_length,
              "env_steps_per_iteration": base.train_batch,
              "phases": phases, "reduced": reduced(args, JAX_DEFAULTS),
              **bench_matrix.device_info(device)}

    def learner_state(cfg):
        learner = PPOLearner(env_params, policy, cfg)
        return learner, learner.init(
            torch.Generator(device).manual_seed(args.seed))

    # -- rollout + GAE (the env-bound share) --------------------------------
    learner, state0 = learner_state(base)

    def rollout_gae(state, acc):
        state, traj, last_value, _ = learner.rollout(state)
        adv, _ = learner._gae(traj, last_value)
        return state, acc + adv.sum()

    first, per, n = time_calls(rollout_gae, state0, args.budget_s,
                               MAX_CALLS, MIN_CALLS)
    phases["rollout_gae_ms"] = per * 1e3
    phases["rollout_gae_samples"] = n
    phases["rollout_gae_first_call_s"] = first

    # -- the rollout's pieces, each as unroll_length calls -------------------
    if args.components:
        obs0 = core.observe(env_params, state0.env_states)
        gen = torch.Generator(device).manual_seed(args.seed + 5)
        pool = pooled.make_pool(env_params, gen,
                                pooled.default_pool_size(
                                    env_params, args.unroll_length),
                                args.num_envs)

        def obs_only(states, acc):
            for _ in range(args.unroll_length):
                ob = core.observe(env_params, states)
                acc = acc + sum(v.sum().to(torch.float32)
                                for v in ob.values())
            return states, acc

        def forward_only(state, acc):
            for _ in range(args.unroll_length):
                _, logp, value, _ = policy.act(obs0, gen)
                acc = acc + value.sum() + logp.sum()
            return state, acc

        def env_step_only(states, acc):
            counts = torch.zeros((args.num_envs,), dtype=torch.int32,
                                 device=device)
            for _ in range(args.unroll_length):
                actions = random_action(gen, env_params, states.action_mask)
                states, counts, reward, _, _ = \
                    pooled.step_autoreset_pooled(env_params, states,
                                                 actions, pool, counts)
                acc = acc + reward.sum()
            return states, acc

        for name, fn in (("obs_only", obs_only),
                         ("policy_forward_only", forward_only),
                         ("env_step_only", env_step_only)):
            _, per, _ = time_calls(fn, state0.env_states, args.budget_s,
                                   MAX_CALLS, MIN_CALLS)
            phases[f"{name}_ms"] = per * 1e3

    # -- the whole train_step at 1 / 10 / 30 SGD epochs ----------------------
    for epochs in EPOCHS:
        learner, state = learner_state(
            dataclasses.replace(base, num_sgd_iter=epochs))

        def step(state, acc, learner=learner):
            state, _ = learner.train_step(state)
            return state, acc + state.kl_coeff

        first, per, _ = time_calls(step, state, args.budget_s, MAX_CALLS,
                                   MIN_CALLS)
        phases[f"train_step_sgd{epochs}_ms"] = per * 1e3
        phases[f"train_step_sgd{epochs}_env_steps_per_sec"] = (
            base.train_batch / per)
        phases[f"train_step_sgd{epochs}_first_call_s"] = first

    # -- one minibatch step, profiled (the last learner's state) ------------
    state, traj, last_value, _ = learner.rollout(state)
    batch = learner.flat_batch(traj, last_value)
    sel = torch.arange(min(base.minibatch_size, base.train_batch),
                       device=device)
    mb = {k: ({o: x[sel] for o, x in v.items()} if k == "obs" else v[sel])
          for k, v in batch.items()}
    learner.minibatch_step(state, mb, state.kl_coeff)          # warm
    result["minibatch_step"] = profile_once(
        lambda: learner.minibatch_step(state, mb, state.kl_coeff), device)

    per_epoch = (phases["train_step_sgd30_ms"]
                 - phases["train_step_sgd1_ms"]) / 29.0
    full = phases["train_step_sgd30_ms"]
    result["derived"] = {
        "sgd_ms_per_epoch": per_epoch,
        "sgd30_share_of_iteration": 30 * per_epoch / full,
        "rollout_gae_share_of_iteration": phases["rollout_gae_ms"] / full,
        "note": ("each epoch runs train_batch / minibatch sequential "
                 "minibatch updates (RLlib 2.2 defaults); rollout+GAE is "
                 "the rest"),
    }
    return finish(result, args.out)


if __name__ == "__main__":
    main()
