"""Carry a Flax ``PlacementModel``'s variables into the port's module.

    sd = state_dict_from_flax(variables, cfg)    # numpy tree -> tensors
    model.load_state_dict(sd, strict=True)       # Policy.load_flax does this

``variables`` is the Flax ``{"params": ..., "batch_stats": ...}`` tree with
numpy leaves (``jax.device_get`` of the JAX package's ``Policy.init``
output, or ``unflatten`` of a flat ``"params/grid_conv/Conv_0/kernel"``
dict as stored in an ``.npz``). The port's submodules carry the Flax
module names, so a Flax path ``a/b/c/leaf`` becomes the key ``a.b.c.<name>``:

  Dense ``kernel`` [in, out]      -> ``weight`` [out, in]
  Conv ``kernel`` HWIO            -> ``weight`` OIHW
  ``bias``                        -> ``bias``
  BatchNorm ``scale``             -> ``weight``
  batch_stats ``mean`` / ``var``  -> ``running_mean`` / ``running_var``
                                     (and ``num_batches_tracked`` = 0)

The result is checked against the module ``cfg`` builds: a missing or
extra key, or a shape that differs, raises. ``to_flax`` maps the other
way, for a state dict or the gradients (``flax_grads``), so that both can
be held to the JAX package's trees path by path.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from placement_tpu_torch.models.zoo import ModelConfig, build_model

Tree = Mapping[str, Union[np.ndarray, "Tree"]]


def _leaves(tree: Tree, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _leaves(v, path + "/")
        else:
            yield path, np.asarray(v)


def flatten(tree: Tree) -> Dict[str, np.ndarray]:
    """{"params": {"a": {"kernel": x}}} -> {"params/a/kernel": x}."""
    return dict(_leaves(tree))


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    """The inverse of ``flatten``."""
    tree: Dict = {}
    for path, v in flat.items():
        *heads, leaf = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = np.asarray(v)
    return tree


def _convert(collection: str, path: str, v: np.ndarray):
    """(state_dict key, tensor) of one Flax leaf."""
    *mods, leaf = path.split("/")
    key = ".".join(mods)
    if collection == "batch_stats":
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        return f"{key}.{name}", torch.from_numpy(np.array(v, np.float32))
    if leaf == "kernel":
        if v.ndim == 2:
            v = v.T                                    # [in, out] -> [out, in]
        elif v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)                # HWIO -> OIHW
        else:
            raise ValueError(f"{path}: kernel of rank {v.ndim}")
        name = "weight"
    elif leaf == "scale":
        name = "weight"
    elif leaf == "bias":
        name = "bias"
    else:
        raise ValueError(f"{collection}/{path}: unknown Flax leaf")
    return f"{key}.{name}", torch.from_numpy(np.array(v, np.float32))


def state_dict_from_flax(variables: Tree, cfg: ModelConfig,
                         component_hw: Optional[Tuple[int, int]] = None
                         ) -> Dict[str, torch.Tensor]:
    """The Flax variables of a ``cfg`` model as the port's ``state_dict``
    (CPU f32 tensors); raises on any key or shape that the port's module
    (``build_model(cfg, component_hw)``) does not have."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unknown Flax collections {sorted(unknown)}")
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, v in _leaves(variables.get(collection, {})):
            key, t = _convert(collection, path, v)
            sd[key] = t
            if key.endswith(".running_mean"):
                sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                    torch.zeros((), dtype=torch.int64)
    with torch.device("meta"):
        want = build_model(cfg, component_hw).state_dict()
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"Flax variables do not fit {cfg.model_type!r}: "
                         f"missing {missing}, unexpected {extra}")
    for k, t in want.items():
        if tuple(sd[k].shape) != tuple(t.shape):
            raise ValueError(f"{k}: shape {tuple(sd[k].shape)} from Flax, "
                             f"{tuple(t.shape)} in the port's module")
    return sd


def to_flax(named: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A state dict, or any ``{state_dict key: tensor}`` such as the
    gradients, as flat Flax paths (``"params/grid_conv/Conv_0/kernel"``,
    ``"batch_stats/.../mean"``) of numpy arrays: the inverse of
    ``state_dict_from_flax``, ``num_batches_tracked`` dropped."""
    out: Dict[str, np.ndarray] = {}
    for key, t in named.items():
        *mods, name = key.split(".")
        path = "/".join(mods)
        v = t.detach().cpu().numpy()
        if name == "num_batches_tracked":
            continue
        if name in ("running_mean", "running_var"):
            out[f"batch_stats/{path}/{name[8:]}"] = v
        elif name == "bias":
            out[f"params/{path}/bias"] = v
        elif name == "weight" and v.ndim == 1:
            out[f"params/{path}/scale"] = v
        elif name == "weight" and v.ndim == 2:
            out[f"params/{path}/kernel"] = v.T
        elif name == "weight" and v.ndim == 4:
            out[f"params/{path}/kernel"] = v.transpose(2, 3, 1, 0)
        else:
            raise ValueError(f"{key}: no Flax counterpart")
    return out


def flax_grads(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The gradients of ``model``'s parameters at their Flax paths (a
    parameter without a gradient raises)."""
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    if missing:
        raise ValueError(f"no gradient for {missing}")
    return to_flax({n: p.grad for n, p in model.named_parameters()})


def norm_fed_biases(paths) -> set:
    """Of the Flax paths ``paths``, the biases that feed a batch norm
    directly: a conv block's ``Conv_i`` before its ``BatchNorm_i``, and the
    rectangle presets' ``flat_feature_dense`` before ``flat_feature_norm``.
    In train mode their gradient is 0 in exact arithmetic (the norm
    subtracts the batch mean), so what any implementation computes for it
    is rounding noise, and Adam turns that noise into steps of up to ``lr``:
    two implementations agree on these parameters only within
    2 * lr a step."""
    paths = set(paths)
    out = set()
    for p in paths:
        head, _, leaf = p.rpartition("/")
        if leaf != "bias":
            continue
        norm = head.replace("/Conv_", "/BatchNorm_").replace(
            "flat_feature_dense", "flat_feature_norm")
        if norm != head and f"{norm}/scale" in paths:
            out.add(p)
    return out
