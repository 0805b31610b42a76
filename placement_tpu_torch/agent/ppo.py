"""PPO actor-learner (port of ``placement_tpu/agent/ppo.py``).

RLlib 2.2's PPO defaults (clip 0.3, lr 5e-5, gamma 0.99, lambda 1.0,
vf_clip 10, kl_coeff 0.2 with its adaptive update, entropy 0.0, 30 SGD
epochs over minibatches of 128 from a 4096-sample batch), as the JAX
learner has them. One iteration is a rollout (``rollout``: observe ->
``Policy.act`` -> the pooled auto-reset step, ``env/pooled.py``) and an
update (``update``: GAE, then minibatched clipped-surrogate Adam steps).
Both halves queue their work on the device and read nothing back: the
caller reads the metrics once an iteration (``Trainer``). The one
exception is the pooled step's finisher count, read once a step, and only
when ``route_budget`` is set.

Randomness comes from the ``TrainState``'s one ``torch.Generator``, which
takes the place of JAX's key splits: the pool, the actions, the
permutations of each epoch and, for factorized presets, the sampled
entropy and KL, in that order.

Data-parallel (a learner with a ``parallel.mesh.Mesh``, made by
``shard_learner``), with the JAX semantics: world n computes what world 1
computes. Every rank advances the common generator as one process would,
each draw made at the whole batch's shape and the rank's rows kept: the
pool (drawn whole, the rank's columns taken), the actions and the sampled
entropy and KL (``shard=(rank, world)``), the permutations (whole). A rank
steps its ``num_envs / world`` boards and all-reduces the window's sums
once an iteration; GAE runs per board, then the window is gathered, so
every rank holds the whole batch and standardises the advantages over it.
Rank r takes block r of each minibatch's ``world`` equal blocks; the
batch norms take the global minibatch's statistics
(``models/blocks.py::sync_batch_norm``), and one flat all-reduce of the
gradients, averaged, is JAX's ``psum``: the gradient of the global mean.
The loss metrics are all-reduced once, at the end of the update.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from placement_tpu_torch.agent.policy import Policy
from placement_tpu_torch.env import core, pooled
from placement_tpu_torch.env.pooled import default_pool_size
from placement_tpu_torch.env.types import STATE_FIELDS, EnvParams, EnvState
from placement_tpu_torch.models.blocks import sync_batch_norm
from placement_tpu_torch.models.zoo import init_parameters
from placement_tpu_torch.parallel.mesh import (
    Mesh, gather_rows, shard_env_batch)

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """RLlib 2.2 PPO defaults (ray.rllib.algorithms.ppo.PPOConfig), copied
    from the JAX package field for field, with its validation."""

    gamma: float = 0.99
    gae_lambda: float = 1.0
    lr: float = 5e-5
    clip_param: float = 0.3
    vf_clip_param: float = 10.0
    vf_loss_coeff: float = 1.0
    entropy_coeff: float = 0.0
    kl_coeff: float = 0.2
    kl_target: float = 0.01
    num_envs: int = 128
    unroll_length: int = 32           # num_envs * unroll = train batch
    minibatch_size: int = 128
    num_sgd_iter: int = 30
    grad_clip: Optional[float] = None
    # Fresh-instance pool entries per board per rollout window (None =
    # derived from the env's minimum episode length: default_pool_size).
    reset_pool_size: Optional[int] = None
    # Per-step finisher budget for gated terminal routing in the rollout
    # (pin variants; None = eager routing every step for every board).
    route_budget: Optional[int] = None

    def __post_init__(self) -> None:
        if self.reset_pool_size is not None and self.reset_pool_size < 1:
            raise ValueError(
                f"reset_pool_size must be >= 1 (or None to derive it), "
                f"got {self.reset_pool_size}")
        if self.route_budget is not None and self.route_budget < 1:
            raise ValueError(
                f"route_budget must be >= 1 (or None for eager routing), "
                f"got {self.route_budget}")
        for field in ("num_envs", "unroll_length", "minibatch_size",
                      "num_sgd_iter"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1, "
                                 f"got {getattr(self, field)}")

    @property
    def train_batch(self) -> int:
        return self.num_envs * self.unroll_length


@dataclasses.dataclass
class TrainState:
    """Everything a run needs to continue: the model (the policy's module,
    weights and BatchNorm buffers), its optimizer, the adaptive KL
    coefficient (a 0-d device tensor), the batched boards, the generator,
    the sample count, and the per-board episode accumulators carried across
    rollout windows (so ``episode_reward_mean`` reports whole episodes, as
    RLlib does)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    kl_coeff: torch.Tensor            # f32[]
    env_states: EnvState              # [num_envs]
    gen: torch.Generator
    steps: int
    ep_return_acc: torch.Tensor       # f32[num_envs]
    ep_len_acc: torch.Tensor          # i32[num_envs]


class Transition(NamedTuple):
    """A rollout window, every field [T, B, ...]."""

    obs: Dict[str, torch.Tensor]
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    dist_inputs: torch.Tensor

    def to(self, device) -> "Transition":
        return Transition(
            {k: v.to(device) for k, v in self.obs.items()},
            *(x.to(device) for x in self[1:]))


class PPOLearner:
    """PPO over a batched placement env, on the policy's device; with a
    ``mesh``, this rank's share of a data-parallel learner (``shard``)."""

    def __init__(self, env_params: EnvParams, policy: Policy,
                 cfg: PPOConfig = PPOConfig(), mesh: Optional[Mesh] = None):
        self.env_params = env_params
        self.policy = policy
        self.cfg = cfg
        self.device = policy.device
        self.mesh = mesh
        self.world = 1 if mesh is None else mesh.world
        # the rank's row block of each draw: None for one rank
        self._shard = None if self.world == 1 else (mesh.rank, mesh.world)
        if mesh is not None:
            # a minibatch longer than the batch is the whole batch
            for field, n in (("num_envs", cfg.num_envs),
                             ("minibatch_size", min(cfg.minibatch_size,
                                                    cfg.train_batch))):
                if n % mesh.world:
                    raise ValueError(f"{field} {n} not divisible by "
                                     f"{mesh.world} ranks")
            sync_batch_norm(policy.model,
                            mesh.group if self.world > 1 else None)

    def shard(self, mesh: Mesh) -> "PPOLearner":
        """This learner over ``mesh`` (``parallel.mesh.shard_learner``): the
        same policy, whose batch norms now sync over the mesh's ranks."""
        return PPOLearner(self.env_params, self.policy, self.cfg, mesh)

    def place(self, state: TrainState) -> TrainState:
        """A freshly initialised single-process ``state`` cut to this rank's
        boards and episode accumulators (model, optimizer, ``kl_coeff``,
        generator and ``steps`` stay whole); the state itself without a
        mesh."""
        if self.mesh is None:
            return state
        rows = self.mesh.rows(self.cfg.num_envs)
        return dataclasses.replace(
            state, env_states=shard_env_batch(self.mesh, state.env_states),
            ep_return_acc=state.ep_return_acc[rows].clone(),
            ep_len_acc=state.ep_len_acc[rows].clone())

    # -- init --------------------------------------------------------------

    def init(self, gen: torch.Generator,
             variables: Optional[Mapping] = None) -> TrainState:
        """Reset ``num_envs`` boards from ``gen`` (on the policy's
        device). The weights are carried from the JAX package's Flax
        ``variables`` (numpy leaves) when given, else drawn with Flax's
        initializers on the CPU from ``gen``'s seed."""
        model = self.policy.model
        if variables is not None:
            self.policy.load_flax(variables)
        else:
            init_parameters(model,
                            torch.Generator().manual_seed(gen.initial_seed()))
        n = self.cfg.num_envs
        env_states = core.reset(self.env_params, gen, n, self.device)
        # optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 added to the
        # bias-corrected root (outside the square root), as PyTorch's Adam
        # adds it; the optional clip by global norm runs before its step
        optimizer = torch.optim.Adam(model.parameters(), lr=self.cfg.lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        return TrainState(
            model=model, optimizer=optimizer,
            kl_coeff=torch.tensor(self.cfg.kl_coeff, dtype=F32,
                                  device=self.device),
            env_states=env_states, gen=gen, steps=0,
            ep_return_acc=torch.zeros((n,), dtype=F32, device=self.device),
            ep_len_acc=torch.zeros((n,), dtype=I32, device=self.device))

    # -- rollout -----------------------------------------------------------

    @torch.no_grad()
    def rollout(self, state: TrainState
                ) -> Tuple[TrainState, Transition, torch.Tensor,
                           Dict[str, torch.Tensor]]:
        """One rollout window with pooled auto-reset (JAX ``:179-246``): the
        pool of replacement boards drawn once, ``unroll_length`` steps of
        observe -> act -> ``pooled.step_autoreset_pooled``. Returns (state,
        trajectory, bootstrap value of the last observation (eval mode),
        the window's sums: ``done``, ``ep_return``, ``ep_len``,
        ``wirelength`` and ``num_intersections`` summed over the finished
        episodes, and ``pool_wraps``, the boards that exhausted the pool
        and replayed an instance, which must stay 0). Over a mesh: this
        rank's boards, the sums over all ranks."""
        params, cfg, gen = self.env_params, self.cfg, state.gen
        pool_size = (default_pool_size(params, cfg.unroll_length)
                     if cfg.reset_pool_size is None
                     else cfg.reset_pool_size)
        pool = pooled.make_pool(params, gen, pool_size, cfg.num_envs)
        if self.mesh is not None:
            rows = self.mesh.rows(cfg.num_envs)
            pool = EnvState(**{f: getattr(pool, f)[:, rows]
                               for f in STATE_FIELDS})
        counts = torch.zeros((state.env_states.batch,), dtype=I32,
                             device=self.device)
        env_states = state.env_states
        ret_acc, len_acc = state.ep_return_acc, state.ep_len_acc
        steps: List[tuple] = []
        sums = {k: torch.zeros((), dtype=F32, device=self.device)
                for k in ("done", "ep_return", "ep_len", "wirelength",
                          "num_intersections")}
        for _ in range(cfg.unroll_length):
            obs = core.observe(params, env_states)
            action, logp, value, dist_inputs = self.policy.act(
                obs, gen, shard=self._shard)
            env_states, counts, reward, done, info = \
                pooled.step_autoreset_pooled(
                    params, env_states, action, pool, counts,
                    route_budget=cfg.route_budget)
            steps.append((obs, action, logp, value, reward, done,
                          dist_inputs))
            ret_total = ret_acc + reward
            len_total = len_acc + 1
            d = done.to(F32)
            sums["done"] += d.sum()
            sums["ep_return"] += (ret_total * d).sum()
            sums["ep_len"] += (len_total * d).sum()
            for key in ("wirelength", "num_intersections"):
                if key in info:                    # pin variants
                    sums[key] += (info[key] * d).sum()
            ret_acc = torch.where(done, 0.0, ret_total)
            len_acc = torch.where(done, 0, len_total)
        sums["pool_wraps"] = (counts > pool_size).sum()
        if self.world > 1:                # the iteration's one reduction
            total = self.mesh.all_reduce(
                torch.stack([v.to(F32) for v in sums.values()]))
            sums = {k: t.to(v.dtype)
                    for (k, v), t in zip(sums.items(), total)}
        obs, action, logp, value, reward, done, dist_inputs = zip(*steps)
        traj = Transition(
            {k: torch.stack([o[k] for o in obs]) for k in obs[0]},
            *map(torch.stack, (action, logp, value, reward, done,
                               dist_inputs)))
        last_value = self.policy.model(
            core.observe(params, env_states))["value"]
        state = dataclasses.replace(state, env_states=env_states,
                                    ep_return_acc=ret_acc,
                                    ep_len_acc=len_acc)
        return state, traj, last_value, sums

    # -- GAE (Postprocessing.compute_gae_for_sample_batch) ------------------

    def _gae(self, traj: Transition, last_value: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(advantages, value targets) [T, B]: the reverse recursion of
        JAX ``:248-265`` as a loop over T."""
        cfg = self.cfg
        adv_next = torch.zeros_like(last_value)
        v_next = last_value
        advantages = [None] * traj.reward.shape[0]
        for t in reversed(range(traj.reward.shape[0])):
            nonterminal = 1.0 - traj.done[t].to(F32)
            delta = (traj.reward[t] + cfg.gamma * v_next * nonterminal
                     - traj.value[t])
            adv_next = (delta
                        + cfg.gamma * cfg.gae_lambda * nonterminal * adv_next)
            v_next = traj.value[t]
            advantages[t] = adv_next
        adv = torch.stack(advantages)
        return adv, adv + traj.value

    # -- loss (ray.rllib.algorithms.ppo.ppo_tf_policy loss) -----------------

    def _loss(self, mb: Dict, kl_coeff: torch.Tensor, gen: torch.Generator
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, aux) on a minibatch (JAX ``:267-291``). The value
        loss clips the *squared error* at ``vf_clip_param`` (RLlib's rule;
        not a clip of the value). The train-mode forward moves the
        BatchNorm statistics."""
        cfg = self.cfg
        logp, entropy, value, kl = self.policy.evaluate(
            mb["obs"], mb["action"], mb["dist_inputs"], gen, self._shard)
        ratio = torch.exp(logp - mb["logp"])
        adv = mb["advantages"]
        surrogate = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param)
            * adv)
        vf_err = torch.square(value - mb["value_targets"])
        vf_loss = torch.clamp(vf_err, 0.0, cfg.vf_clip_param)
        mean_kl = kl.mean()
        policy_loss = -surrogate.mean()
        total = (policy_loss + cfg.vf_loss_coeff * vf_loss.mean()
                 - cfg.entropy_coeff * entropy.mean() + kl_coeff * mean_kl)
        aux = {"policy_loss": policy_loss, "vf_loss": vf_loss.mean(),
               "entropy": entropy.mean(), "kl": mean_kl}
        return total, aux

    def _clip_by_global_norm(self, params: List[torch.Tensor]) -> None:
        """``optax.clip_by_global_norm``: every gradient times max_norm /
        norm where norm >= max_norm, on the device (no ``+ 1e-6`` as in
        ``clip_grad_norm_``)."""
        grads = [p.grad for p in params]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        max_norm = self.cfg.grad_clip
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))

    def _average_grads(self, params: List[torch.Tensor]) -> None:
        """Every gradient replaced by its mean over the ranks: one flat
        all-reduce, the gradients left as views of its result."""
        params = [p for p in params if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        self.mesh.all_reduce(flat).div_(self.world)
        off = 0
        for p in params:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()

    def minibatch_step(self, state: TrainState, mb: Dict,
                       kl_coeff: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One Adam step on the minibatch ``mb`` (over a mesh: this rank's
        block of it, the gradients averaged over the ranks); returns the
        loss's aux (detached)."""
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss, aux = self._loss(mb, kl_coeff, state.gen)
        loss.backward()
        if self.world > 1:
            self._average_grads(
                [p for g in opt.param_groups for p in g["params"]])
        if self.cfg.grad_clip is not None:
            self._clip_by_global_norm(
                [p for g in opt.param_groups for p in g["params"]])
        opt.step()
        return {k: v.detach() for k, v in aux.items()}

    # -- update ------------------------------------------------------------

    def flat_batch(self, traj: Transition, last_value: torch.Tensor
                   ) -> Dict:
        """The window as one batch [T * B, ...] with GAE advantages
        (standardised) and value targets. Over a mesh: GAE on this rank's
        boards, then every rank's window gathered (one collective), so
        that each rank holds the whole batch in world 1's row order."""
        advantages, value_targets = self._gae(traj, last_value)
        window = [*traj.obs.values(), traj.action, traj.logp, traj.value,
                  traj.dist_inputs, value_targets, advantages]
        if self.world > 1:                # [T, B / world] -> [T, B]
            window = gather_rows(self.mesh, window, dim=1)
        *obs, action, logp, value, dist_inputs, value_targets, adv = [
            x.reshape((-1,) + x.shape[2:]) for x in window]
        # RLlib standardize_fields=["advantages"], with the *population*
        # std as jnp.std (ddof 0; torch.std defaults to ddof 1)
        adv = (adv - adv.mean()) / torch.clamp_min(
            adv.std(correction=0), 1e-4)
        return {
            "obs": dict(zip(traj.obs, obs)),
            "action": action, "logp": logp, "value": value,
            "dist_inputs": dist_inputs, "advantages": adv,
            "value_targets": value_targets,
        }

    def update(self, state: TrainState, traj: Transition,
               last_value: torch.Tensor,
               perms: Optional[Sequence[torch.Tensor]] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """``num_sgd_iter`` epochs of minibatched Adam steps on the window
        (JAX ``:293-360``), then the adaptive KL coefficient. Each epoch
        takes a fresh permutation of the batch (``perms[e]`` when given,
        else drawn from the state's generator) and ``n // minibatch_size``
        minibatches of it; the remainder is dropped, as in JAX. Returns
        (state, {policy_loss, vf_loss, entropy: means over every
        minibatch; kl: the mean over the *last* epoch (JAX ``:354``), which
        also drives the coefficient; kl_coeff}). Over a mesh: ``traj`` and
        ``last_value`` are this rank's boards, ``perms`` the whole batch's,
        and every rank returns the same metrics."""
        cfg = self.cfg
        batch = self.flat_batch(traj, last_value)
        n = cfg.train_batch
        n_mb = max(n // cfg.minibatch_size, 1)
        block = min(cfg.minibatch_size, n) // self.world
        first = 0 if self.mesh is None else self.mesh.rank * block
        kl_coeff = state.kl_coeff
        auxes: List[Dict[str, torch.Tensor]] = []
        for epoch in range(cfg.num_sgd_iter):
            perm = (torch.randperm(n, generator=state.gen,
                                   device=self.device)
                    if perms is None else perms[epoch].to(self.device))
            for i in range(n_mb):
                sel = perm[i * cfg.minibatch_size:
                           (i + 1) * cfg.minibatch_size]
                if self.world > 1:        # this rank's block
                    sel = sel[first:first + block]
                mb = {k: ({o: x.index_select(0, sel) for o, x in v.items()}
                          if k == "obs" else v.index_select(0, sel))
                      for k, v in batch.items()}
                auxes.append(self.minibatch_step(state, mb, kl_coeff))
        aux = {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}
        if self.world > 1:                # the ranks' means of each step
            total = self.mesh.all_reduce(torch.stack(list(aux.values())))
            aux = dict(zip(aux, total / self.world))
        # adaptive KL coefficient (RLlib update_kl) on the last epoch's kl
        mean_kl = aux["kl"][-n_mb:].mean()
        kl_coeff = torch.where(
            mean_kl > 2.0 * cfg.kl_target, kl_coeff * 1.5,
            torch.where(mean_kl < 0.5 * cfg.kl_target, kl_coeff * 0.5,
                        kl_coeff))
        metrics = {"policy_loss": aux["policy_loss"].mean(),
                   "vf_loss": aux["vf_loss"].mean(),
                   "entropy": aux["entropy"].mean(),
                   "kl": mean_kl, "kl_coeff": kl_coeff}
        return dataclasses.replace(state, kl_coeff=kl_coeff), metrics

    # -- one full train iteration ------------------------------------------

    def train_step(self, state: TrainState
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """``rollout`` then ``update``; the metrics (0-d device tensors)
        carry exactly the JAX train step's keys (``:362-380``), sorted as
        the jitted JAX step returns them (a pytree's dict keys are
        sorted), which orders progress.csv's columns."""
        state, traj, last_value, roll = self.rollout(state)
        state, metrics = self.update(state, traj, last_value)
        n_done = torch.clamp_min(roll["done"], 1.0)
        metrics.update({
            "episode_reward_mean": roll["ep_return"] / n_done,
            "episode_len_mean": roll["ep_len"] / n_done,
            "episodes_this_iter": roll["done"].to(I32),
            # custom metrics parity (utils/agent/callbacks.py:35-42)
            "normalized_wirelengths_mean": roll["wirelength"] / n_done,
            "num_intersections_mean": roll["num_intersections"] / n_done,
            "pool_wraps": roll["pool_wraps"].to(I32),
        })
        state = dataclasses.replace(state,
                                    steps=state.steps + self.cfg.train_batch)
        return state, dict(sorted(metrics.items()))
