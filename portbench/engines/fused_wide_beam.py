"""The fused rollout engine of boards of many components under the beam
and "both" rewards: ``engines/fused_wide.py``'s set-up, windows, kept
chunks and comparison, held to ``portbench/reference_wide_beam.py`` (the
plain reference with its beam route in wide operations too, so a chunk is
checked in seconds and not in minutes).

Its profiled window adds a reading of what the beam route costs: the same
chunks (the traced window's first input leaves, then the same chunk seeds,
chained) run again through a second rollout of the same configuration
under the centroid reward, on the same instantiation. Placement and
regeneration do not depend on the reward, so both rollouts run the same
boards and episodes; the beam chunk's kernel time less the centroid one's,
each read as ``kernel_ms.rollout`` reads it, is the beam route's cost over
the centroid route's, a chunk (``beam_route_ms.rollout``).

A traffic file names this engine (``"engine": "fused_wide_beam"``) and
gives the same keys as one of ``fused``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from portbench import devtrace, reference_wide_beam
from portbench.engines import fused, fused_wide


class Engine(fused_wide.Engine):
    """``fused_wide.Engine`` whose check runs ``reference_wide_beam``, and
    whose profiled window also times the same chunks under the centroid
    reward."""

    #: ``fused_wide.Engine.check``, the same code, with this reference
    check = reference_wide_beam.rebind(fused_wide.Engine.check,
                                      reference_wide=reference_wide_beam)

    def trace(self, keep: int) -> Dict[str, Any]:
        """``fused.Engine.trace``'s reading, and under ``centroid`` the
        reading of the same chunks' profiled window under the centroid
        reward (its ``kernels`` and ``chunks``)."""
        leaves, first = self.leaves, self.chunks
        got = super().trace(keep)
        got["centroid"] = self._centroid_window(leaves, first)
        return got

    def _centroid_window(self, leaves: Dict[str, torch.Tensor],
                         first: int) -> Dict[str, Any]:
        from torch.profiler import record_function

        from placement_tpu_torch.ops import fused_rollout

        fn = fused_rollout.make_fused_rollout(
            self.params.replace(reward_type="centroid"), self.boards,
            self.steps, block=self.block, device=self.device)
        if fn.tier != self.fn.tier:
            raise RuntimeError(f"the centroid rollout runs the {fn.tier} "
                               f"instantiation, the beam one the "
                               f"{self.fn.tier}")
        acc = torch.zeros(self.boards, dtype=torch.float32,
                          device=self.device)
        fn.per_board(leaves, self.seed_base)        # load its kernel
        state = {"leaves": leaves, "chunk": first}

        def chunk():
            seed = (self.seed_base + state["chunk"]) & fused._M32
            with record_function(devtrace.CHUNK):
                state["leaves"], rsum, _ = fn.per_board(state["leaves"],
                                                        seed)
            acc.add_(rsum)
            state["chunk"] += 1

        got = devtrace.profile(chunk, fused.TRACED_CHUNKS,
                               lambda: float(acc.sum()))
        return {"kernels": got["kernels"], "chunks": got["chunks"]}
