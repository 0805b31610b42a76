"""Keep-N checkpoints of a PPO ``TrainState`` (port of
``placement_tpu/utils/checkpoint.py``).

Replaces Ray Tune's checkpointing (``tune.run(..., checkpoint_freq=1,
checkpoint_at_end=True, keep_checkpoints_num=5)``,
``experiments/PPO/PPO.py:43-45``), which the JAX package does with Orbax.
A checkpoint is one ``torch.save`` of the whole state: the model's
``state_dict`` (BatchNorm buffers included), the optimizer's, the adaptive
KL coefficient, every ``EnvState`` field, the generator's state, the sample
count and the episode accumulators, so a restored run continues exactly
where the saved one stopped. Each lands in ``checkpoint_<step>/state.pt``,
written to a temporary file and renamed, so a crash never leaves half a
checkpoint. Saves are synchronous: ``wait`` and ``close`` have nothing to
finish.

Over a data-parallel mesh a checkpoint holds the *global* state, as
Orbax's does: each save gathers the ranks' boards and episode
accumulators (a collective: every rank calls ``save``), rank 0 writes the
file, and a barrier follows; on restore every rank reads the file and
keeps its rows. So a checkpoint restores at any world size that divides
its boards, one process included.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from placement_tpu_torch.env.types import STATE_FIELDS, EnvState
from placement_tpu_torch.parallel.mesh import Mesh, gather_rows

_STEP_DIR = re.compile(r"^checkpoint_(\d+)$")
_FILE = "state.pt"


def _payload(state, mesh: Optional[Mesh]) -> Dict[str, Any]:
    """The checkpoint's contents, the boards of every rank gathered."""
    rows = [getattr(state.env_states, f) for f in STATE_FIELDS] + [
        state.ep_return_acc, state.ep_len_acc]
    if mesh is not None:
        rows = gather_rows(mesh, rows)
    return {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "kl_coeff": state.kl_coeff,
        "env_states": dict(zip(STATE_FIELDS, rows)),
        "gen": state.gen.get_state(),
        "steps": int(state.steps),
        "ep_return_acc": rows[-2],
        "ep_len_acc": rows[-1],
    }


class CheckpointManager:
    """Keep the newest ``max_to_keep`` checkpoints of a ``TrainState``
    under ``directory``, saving on steps that are multiples of
    ``save_interval`` (or when forced); with a ``mesh``, the global state
    of its ranks (one directory that every rank reads)."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_interval: int = 1, mesh: Optional[Mesh] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step}")

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save ``state`` as step ``step``; False when the interval skips
        it. Drops the oldest checkpoints beyond ``max_to_keep``."""
        if not force and step % self.save_interval != 0:
            return False
        payload = _payload(state, self.mesh)
        if self.mesh is None or self.mesh.rank == 0:
            path = self._dir(step)
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, _FILE + ".tmp")
            torch.save(payload, tmp)
            os.replace(tmp, os.path.join(path, _FILE))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._dir(old), ignore_errors=True)
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group)
        return True

    def restore(self, target, step: Optional[int] = None):
        """Load checkpoint ``step`` (default: the newest, as
        ``PPO.restore(checkpoint_path)``, utils/agent/utils.py:218-219)
        into ``target``, a ``TrainState`` of the same learner (e.g. its
        ``init``): the model and optimizer in place, the tensors onto
        ``target``'s device (over a mesh, its rows of the boards). Returns
        the restored state."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        data = torch.load(os.path.join(self._dir(step), _FILE),
                          map_location="cpu", weights_only=True)
        device = target.kl_coeff.device
        rows = (slice(None) if self.mesh is None else
                self.mesh.rows(data["ep_len_acc"].shape[0]))
        target.model.load_state_dict(data["model"])
        target.optimizer.load_state_dict(data["optimizer"])
        target.gen.set_state(data["gen"])
        return dataclasses.replace(
            target,
            kl_coeff=data["kl_coeff"].to(device),
            env_states=EnvState(**{f: data["env_states"][f][rows].to(device)
                                   for f in STATE_FIELDS}),
            steps=int(data["steps"]),
            ep_return_acc=data["ep_return_acc"][rows].to(device),
            ep_len_acc=data["ep_len_acc"][rows].to(device))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """Steps with a complete checkpoint, oldest first."""
        steps = []
        for d in os.listdir(self.directory):
            m = _STEP_DIR.match(d)
            if m and os.path.exists(os.path.join(self.directory, d, _FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""


def find_latest_run(results_root: str, prefix: str = "") -> str:
    """Newest run directory under ``results_root`` by mtime — the analogue of
    generate_rollouts' newest-``~/ray_results/PPO/*`` lookup
    (utils/agent/utils.py:165-178)."""
    entries = [os.path.join(results_root, d) for d in os.listdir(results_root)
               if d.startswith(prefix)
               and os.path.isdir(os.path.join(results_root, d))]
    if not entries:
        raise FileNotFoundError(
            f"no run directories under {results_root!r} with prefix {prefix!r}")
    return max(entries, key=os.path.getmtime)
