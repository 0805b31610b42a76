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
extra key, or a shape that differs, raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

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


def state_dict_from_flax(variables: Tree, cfg: ModelConfig
                         ) -> Dict[str, torch.Tensor]:
    """The Flax variables of a ``cfg`` model as the port's ``state_dict``
    (CPU f32 tensors); raises on any key or shape that the port's module
    does not have."""
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
        want = build_model(cfg).state_dict()
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"Flax variables do not fit {cfg.model_type!r}: "
                         f"missing {missing}, unexpected {extra}")
    for k, t in want.items():
        if tuple(sd[k].shape) != tuple(t.shape):
            raise ValueError(f"{k}: shape {tuple(sd[k].shape)} from Flax, "
                             f"{tuple(t.shape)} in the port's module")
    return sd
