"""The ``fused_wide_beam`` engine for beams wider than four: the same
set-up, windows, check (``portbench/reference_wide_beam.py``) and profiled
window, whose second reading times the same chunks under the centroid
reward (``beam_route_ms.rollout``'s and ``beam6_route_ms.rollout``'s).

Past width 4 the beam rollout runs the pin kernels' ``wide6``
instantiation and the centroid one the ``wide`` instantiation, since the
centroid kernel has one wide instantiation: the same boards, tables,
generator and placement, whose code is one source in both. So the second
rollout is held to the wide family, where ``fused_wide_beam`` holds it to
the beam rollout's own instantiation.

A traffic file names this engine (``"engine": "fused_wide_beam6"``) and
gives the same keys as one of ``fused``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from portbench import devtrace
from portbench.engines import fused, fused_wide_beam

#: the instantiations whose boards and tables are the wide tier's
WIDE_FAMILY = ("wide", "wide6")


class Engine(fused_wide_beam.Engine):
    """``fused_wide_beam.Engine`` whose centroid rollout may run the wide
    instantiation beside the beam rollout's wide6 one."""

    def _centroid_window(self, leaves: Dict[str, torch.Tensor],
                         first: int) -> Dict[str, Any]:
        from torch.profiler import record_function

        from placement_tpu_torch.ops import fused_rollout

        fn = fused_rollout.make_fused_rollout(
            self.params.replace(reward_type="centroid"), self.boards,
            self.steps, block=self.block, device=self.device)
        if fn.tier not in WIDE_FAMILY or self.fn.tier not in WIDE_FAMILY:
            raise RuntimeError(f"the centroid rollout runs the {fn.tier} "
                               f"instantiation, the beam one the "
                               f"{self.fn.tier}: not both wide")
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
