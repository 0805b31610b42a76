"""Policy: one interface over joint-logit and factorized models (the acting
half of ``placement_tpu/agent/policy.py``).

A ``Policy`` holds its ``PlacementModel`` on a device, in eval mode, and
turns a batch of observations into actions, their log-probabilities and
values. Its weights come from ``init_parameters`` (Flax's initializer
distributions, from a seed) or are carried from the JAX package with
``load_flax``. ``evaluate`` re-scores stored transitions for the PPO loss
(``agent/ppo.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from placement_tpu_torch.env import core
from placement_tpu_torch.env.types import EnvParams, EnvState, Variant
from placement_tpu_torch.env.wrappers import (
    decode_flat_action, encode_flat_action)
from placement_tpu_torch.models import convert
from placement_tpu_torch.models import distributions as D
from placement_tpu_torch.models.zoo import (
    ModelConfig, PlacementModel, build_model, init_parameters)


def model_config_for(params: EnvParams, model_type: str,
                     **overrides) -> ModelConfig:
    """The model config whose sizes fit ``params``."""
    base = dict(
        model_type=model_type,
        height=params.height, width=params.width,
        num_orientations=params.num_orientations,
        max_num_components=params.max_components,
        max_num_nets=params.max_num_nets,
        max_num_pins_per_component=params.max_num_pins_per_component,
        component_feature_vector_width=(
            5 + params.max_num_pins_per_component
            if params.variant == Variant.PIN_SPATIAL else 5),
        pin_feature_vector_width=4 + params.max_num_nets + 1,
    )
    base.update(overrides)
    return ModelConfig(**base)


class Policy:
    """A (model, env) pair on ``device``: the card unless the CPU is asked
    for (raises without a card). The weights are drawn from ``seed`` with
    Flax's initializers until ``load_flax`` replaces them."""

    def __init__(self, env_params: EnvParams, cfg: ModelConfig,
                 device: core.Device = "cuda", seed: int = 0):
        self.env_params = env_params
        self.cfg = cfg
        self.device = core.check_device(device, "Policy")
        self.component_hw = (env_params.max_component_h,
                             env_params.max_component_w)
        model = build_model(cfg, self.component_hw)
        init_parameters(model, torch.Generator().manual_seed(seed))
        self.model: PlacementModel = model.to(self.device).eval()

    def load_flax(self, variables: Mapping) -> "Policy":
        """Carry the JAX package's Flax variables (numpy leaves) into the
        module; a missing, extra or misshapen entry raises."""
        sd = convert.state_dict_from_flax(variables, self.cfg,
                                          self.component_hw)
        self.model.load_state_dict(sd, strict=True)
        return self

    def factorized_dist(self, enc: torch.Tensor, mask: torch.Tensor
                        ) -> D.Factorized:
        """The factorized distribution of a factorized preset over its
        encoding ``enc`` and the f32 action mask."""
        m, cfg = self.model, self.cfg
        heads = D.FactorizedHeads(m.o_logits, m.x_logits, m.y_logits,
                                  cfg.num_orientations, cfg.height, cfg.width)
        return D.Factorized(heads, enc, mask, cfg.factorization)

    @torch.no_grad()
    def act(self, obs: Dict[str, torch.Tensor], gen: torch.Generator,
            deterministic: bool = False, shard: Optional[D.Shard] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """obs (batched) -> (action i32[B, 3], logp f32[B], value f32[B],
        dist_inputs): the masked logits, or the encoding for factorized
        heads (what PPO stores to rebuild the behaviour distribution,
        RLlib's SampleBatch.ACTION_DIST_INPUTS). ``gen`` draws the
        samples (unused when ``deterministic``: the argmax); ``shard=(r,
        n)``: ``obs`` is a rank's block r of n, drawn for at the whole
        batch's shape (``distributions.cat_sample``)."""
        out = self.model(obs)
        value = out["value"]
        if self.cfg.is_factorized:
            enc = out["encoding"]
            dist = self.factorized_dist(enc, obs["action_mask"])
            action = dist.sample(gen, deterministic, shard)
            return action.to(torch.int32), dist.logp(action), value, enc
        logits = out["logits"]
        flat = (D.cat_argmax(logits) if deterministic
                else D.cat_sample(gen, logits, shard))
        action = decode_flat_action(self.env_params, flat)
        return action, D.cat_logp(logits, flat), value, logits

    def evaluate(self, obs: Dict[str, torch.Tensor], actions: torch.Tensor,
                 behavior_inputs: torch.Tensor, gen: torch.Generator,
                 shard: Optional[D.Shard] = None
                 ) -> Tuple[torch.Tensor, ...]:
        """(logp, entropy, value, kl) of stored transitions under the
        current weights, with gradients (JAX ``agent/policy.py:113-135``).

        The forward runs in train mode, so the BatchNorm layers normalise
        with the batch's statistics and move their running statistics
        (Flax's rule, ``models/blocks.py::BatchNorm``); the module is back
        in eval mode on return. ``kl`` is KL(behaviour || current), the
        behaviour distribution rebuilt from ``behavior_inputs`` (its masked
        logits, or its encoding under the *current* heads for factorized
        presets, gradients through them as in JAX). A factorized preset's
        entropy and KL are sampled estimates, drawn from ``gen`` in JAX's
        order: the entropy's draws, then the KL's (``shard`` as in
        ``act``)."""
        self.model.train()
        try:
            out = self.model(obs)
        finally:
            self.model.eval()
        value = out["value"]
        if self.cfg.is_factorized:
            dist = self.factorized_dist(out["encoding"], obs["action_mask"])
            prev = self.factorized_dist(behavior_inputs, obs["action_mask"])
            logp = dist.logp(actions)
            entropy = dist.entropy(gen, shard)
            return logp, entropy, value, prev.kl(dist, gen, shard)
        logits = out["logits"]
        flat = encode_flat_action(self.env_params, actions)
        return (D.cat_logp(logits, flat), D.cat_entropy(logits), value,
                D.cat_kl(behavior_inputs, logits))

    def policy_fn(self):
        """``fn(gen, params, states) -> actions``: observe the boards and
        sample, for ``pooled.rollout_chunk``."""
        def fn(gen: torch.Generator, params: EnvParams,
               states: EnvState) -> torch.Tensor:
            return self.act(core.observe(params, states), gen)[0]
        return fn
