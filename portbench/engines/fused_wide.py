"""The fused rollout engine (``engines/fused.py``) held to
``portbench/reference_wide.py``: the same set-up, windows and kept chunks,
and the same comparison, with the plain reference that computes the chunk
in fewer, wider operations, so that a chunk of boards of many components
is checked in seconds and not in minutes.

A traffic file names this engine (``"engine": "fused_wide"``) and gives
the same keys as one of ``fused``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench import reference, reference_wide
from portbench.engines import fused


class Engine(fused.Engine):
    """``fused.Engine`` whose check runs ``reference_wide``."""

    def check(self, against: Optional[torch.dtype] = None
              ) -> List[Dict[str, float]]:
        """As ``fused.Engine.check``: set-up's first chunk and each chunk
        kept from the window, its input through the plain reference in
        float32, against the program's output (``against`` None) or
        against the reference in ``against`` (the control). Returns, a
        kept chunk each, the leaf elements that differ, the largest gap of
        a board's done count, and of a board's reward sum."""
        out = []
        for chunk_seed, leaves_in, leaves_out, rsum, dcnt in (
                self.start + self.kept):
            want = reference_wide.rollout_chunk(
                self.ref_params, leaves_in, chunk_seed, self.steps,
                self.block)
            got = (leaves_out, rsum, dcnt) if against is None else \
                reference_wide.rollout_chunk(
                    self.ref_params, leaves_in, chunk_seed, self.steps,
                    self.block, against)
            out.append({
                "leaf_mismatch": float(sum(
                    int((got[0][n] != want[0][n]).sum())
                    for n in reference.LEAVES)),
                "done_gap": float(
                    (got[2].long() - want[2].long()).abs().max()),
                "reward_gap": float(
                    (got[1].double() - want[1].double()).abs().max())})
        return out
