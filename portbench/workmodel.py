"""The least time an H100 could take for one fused chunk: the yardstick of
``kernel_roofline_pct.rollout`` and ``rollout_mfu``.

A frozen copy of ``chip_smoke.py``'s ``_chunk_bound`` and ``_route_pairs``
with their peaks. It counts the work of the rows algorithm (a grid row a
lane) for the episodes and the pins of the data actually run, whatever
implements the chunk, so a later change to the kernels cannot move it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.reference import Params, kernel_name, leaf_widths

#: an H100 SXM's rates (NVIDIA's data sheet and Hopper white paper): HBM3
#: bytes/s; non-tensor instructions, 128 lanes an SM a clock over 132 SMs at
#: the 1.98 GHz boost clock (the published 67 TFLOP/s of float32 with an FMA
#: counted as two), of which 64 lanes may be integer
HBM_BYTES_S = 3.35e12
LANE_OPS_S = 132 * 128 * 1.98e9
INT_OPS_S = 132 * 64 * 1.98e9


def route_pairs(params: Params, leaves: Dict[str, torch.Tensor]
                ) -> Tuple[float, float, float]:
    """Per board, averaged over ``leaves``: the pins in use, and the segment
    pairs each routing reward tests for a crossing. Both test only pairs on
    different nets. The centroid route has a segment per pin, but one for a
    2-pin net; the beam route has ``min(count, M) - 1`` per net. Returns
    (pins, centroid pairs, beam pairs)."""
    N, M = params.max_num_nets, params.max_num_pins_per_net
    net = leaves["pin_net"].long()
    slot = torch.arange(net.shape[1], device=net.device)
    ok = (slot < leaves["num_pins"]) & (net >= 0) & (net < N)
    cnt = torch.zeros(net.shape[0], N + 1, dtype=torch.int64,
                      device=net.device)
    cnt.scatter_add_(1, torch.where(ok, net, N), torch.ones_like(net))
    cnt = cnt[:, :N]

    def pairs(seg):
        return float(((seg.sum(1) ** 2 - (seg * seg).sum(1)) // 2)
                     .double().mean())

    return (float(ok.sum(1).double().mean()),
            pairs(torch.where(cnt == 2, 1, cnt)),
            pairs((cnt.clamp(max=M) - 1).clamp(min=0)))


def chunk_bound(params: Params, batch: int, steps: int, episodes: float,
                leaves: Dict[str, torch.Tensor]
                ) -> Tuple[float, str, float, int]:
    """The least time the card could take for one chunk: bytes (every leaf
    read once and written once, plus the per-board sums) over the HBM rate,
    or the operations the rows algorithm does for this data over the
    instruction rates, whichever is larger. Operations are counted from the
    code (a model, not a measurement): per board-step the action sampling,
    the paint, the pin rotation and the next legality planes; per episode
    (``episodes`` a chunk, pins and crossing tests as on ``leaves``' boards)
    the generator and the routing reward. Returns (ms, "bytes" or
    "operations", operations, bytes)."""
    H, C, N = params.height, params.max_components, params.max_num_nets
    M, PPC = params.max_num_pins_per_net, params.max_num_pins_per_component
    fp = max(params.max_component_h, params.max_component_w)
    kernel = kernel_name(params)
    planes = 1 if kernel == "square" else 2
    step = planes * H * (2 * fp + 6) + 3 * H + 40 + fp
    gen = 10 * C
    route_int = route_fp = 0.0
    if params.has_pins:
        pins, centroid_pairs, beam_pairs = route_pairs(params, leaves)
        step += 10 * params.max_pins
        gen = (N * (4 * C * C + 4 * M * C + 20) + 2 * C * PPC * PPC
               + pins * (N + 15) + 20 * C)
        if params.max_num_pins_per_net > params.min_num_pins_per_net:
            span = params.max_num_pins_per_net - params.min_num_pins_per_net
            gen += 60 * N + span * N * N
        if kernel in ("centroid", "both"):
            route_int += 20 * pins + 10 * N
            route_fp += 35 * centroid_pairs
        if kernel in ("beam", "both"):
            bw = int(params.reward_beam_width)
            rounds = max(pins / N - 1, 0)
            route_int += N * rounds * bw * (6 * M + 2 * bw * M + 8 * bw * bw)
            route_fp += 35 * beam_pairs
    ops_int = batch * steps * step + episodes * (gen + route_int)
    ops_fp = episodes * route_fp
    nbytes = 2 * 4 * batch * sum(leaf_widths(params).values()) + 8 * batch
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(ops_int / INT_OPS_S, (ops_int + ops_fp) / LANE_OPS_S)
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, ops_int + ops_fp, nbytes
