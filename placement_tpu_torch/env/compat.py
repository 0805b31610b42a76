"""NumPy-faithful reference-stream instance generator (parity harness; the
port's own copy of ``placement_tpu/env/compat.py``, against the port's
``EnvParams`` and ``Variant``: NumPy only, no import of the JAX package).

The production generator (``env/generator.py``) draws instances from the same
distributions as the reference but with its own PRNG and vectorized sampling —
it cannot reproduce the reference's exact ``np.random`` / ``random`` bit
streams. This module CAN: it re-derives, call for call, the RNG consumption
of ``DummyPlacementEnv.generate_instances``
(dummy_env_rectangular_pin.py:1006-1035) so that after
``np.random.seed(s); random.seed(s)`` it produces byte-identical instances to
``env.reset()`` on the reference. It is host-side NumPy only (never jitted)
and exists for the exact-seed parity suite (``tests/parity/``), satisfying
the BASELINE requirement of fixed-seed trajectory/mask/return parity.

Stream-order notes (each bullet = one reference call site, in order):
  * component count: one ``np.random.randint``       (sample_num_components:1040)
  * per component: two ``np.random.randint`` (h, w)  (generate_components:991-997)
  * net count: one ``np.random.randint``             (sample_num_nets:1043)
  * total pins: one ``np.random.randint``            (sample_total_num_pins:1056)
  * pins->nets: ``np.random.normal(size=nets)`` then, if extras remain, one
    ``np.random.multinomial(1, ...)`` per extra pin   (allocate_pins_to_nets:1067,
    sample_truncated_multinomial:258-295)
  * pins->components: per net, one ``np.random.multinomial`` per while-round
                                                     (allocate_pins_to_components_for_net:1237)
  * pin cells: one ``random.choice`` per pin         (place_pins_on_component:1478-1498)
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from placement_tpu_torch.env.types import EnvParams, Variant


@dataclass
class CompatPin:
    """Host-side mirror of the reference Pin (dummy_env_rectangular_pin.py:13)."""
    rel_x: int = -1
    rel_y: int = -1
    pin_id: int = -1
    comp_id: int = -1
    net_id: int = -1


@dataclass
class CompatInstance:
    """One generated instance in the reference's final layout: ``pins`` is in
    rebuilt ``self.pins`` order (net-grouped, :1167-1169)."""
    num_components: int
    comp_h: List[int]
    comp_w: List[int]
    num_nets: int = 0
    pins: List[CompatPin] = field(default_factory=list)

    def arrays(self, params: EnvParams) -> Dict[str, np.ndarray]:
        """Padded EnvState-layout arrays (see env/types.py EnvState)."""
        c, p = params.max_components, params.max_pins
        out = {
            "num_components": np.int32(self.num_components),
            "comp_h": np.zeros(c, np.int32),
            "comp_w": np.zeros(c, np.int32),
            "num_nets": np.int32(self.num_nets),
            "num_pins": np.int32(len(self.pins)),
            "pin_rel_x": np.full(p, -1, np.int32),
            "pin_rel_y": np.full(p, -1, np.int32),
            "pin_net": np.full(p, -1, np.int32),
            "pin_comp": np.full(p, -1, np.int32),
            "pin_local": np.zeros(p, np.int32),
        }
        out["comp_h"][:self.num_components] = self.comp_h
        out["comp_w"][:self.num_components] = self.comp_w
        for i, q in enumerate(self.pins):
            out["pin_rel_x"][i] = q.rel_x
            out["pin_rel_y"][i] = q.rel_y
            out["pin_net"][i] = q.net_id
            out["pin_comp"][i] = q.comp_id
            out["pin_local"][i] = q.pin_id
        return out


def _truncated_multinomial(n: int, m: int, p: np.ndarray,
                           k: int) -> np.ndarray:
    """Per-trial renormalizing capped multinomial — the same sequence of
    ``np.random.multinomial(1, ...)`` calls as the reference's
    ``sample_truncated_multinomial`` (dummy_env_rectangular_pin.py:258-295)."""
    counts = np.zeros(n, dtype=int)
    for _ in range(m):
        trial_p = p * (counts < k)
        trial_p = trial_p / np.sum(trial_p)
        counts += np.random.multinomial(1, trial_p)
    return counts


def generate_square_instance(params: EnvParams) -> CompatInstance:
    """The square env consumes no RNG at reset (dummy_env_square.py:74-113)."""
    return CompatInstance(num_components=1, comp_h=[params.component_n],
                          comp_w=[params.component_n])


def generate_rect_instance(params: EnvParams) -> CompatInstance:
    """Rect env: count then (h, w) per component, scalar draws in creation
    order (dummy_env_rectangular.py:253-276)."""
    num = int(np.random.randint(params.min_num_components,
                                params.max_num_components + 1))
    hs, ws = [], []
    for _ in range(num):
        hs.append(int(np.random.randint(params.min_component_h,
                                        params.max_component_h + 1)))
        ws.append(int(np.random.randint(params.min_component_w,
                                        params.max_component_w + 1)))
    return CompatInstance(num_components=num, comp_h=hs, comp_w=ws)


def generate_pin_instance(params: EnvParams) -> CompatInstance:
    """Pin / pin-spatial instance, reproducing generate_instances:1006-1035
    exactly (both the values and the RNG stream)."""
    spatial = params.variant == Variant.PIN_SPATIAL

    # --- components (generate_components:983-1004) -------------------------
    num_components = int(np.random.randint(params.min_num_components,
                                           params.max_num_components + 1))
    comp_h, comp_w = [], []
    for _ in range(num_components):
        comp_h.append(int(np.random.randint(params.min_component_h,
                                            params.max_component_h + 1)))
        comp_w.append(int(np.random.randint(params.min_component_w,
                                            params.max_component_w + 1)))
    areas = [h * w for h, w in zip(comp_h, comp_w)]
    total_area = sum(areas)

    # --- net / pin counts (sample_num_nets:1043, sample_total_num_pins:1050)
    num_nets = int(np.random.randint(params.min_num_nets,
                                     params.max_num_nets + 1))
    num_nets = min(num_nets, int(total_area / 2))
    total_pins = int(np.random.randint(
        params.min_num_pins_per_net * num_nets,
        params.max_num_pins_per_net * num_nets + 1))
    total_pins = min(total_pins, total_area)

    # --- pins -> nets (allocate_pins_to_nets:1067-1127) --------------------
    # Pins are created with pin_id = creation index (generate_pins:977-981);
    # base block of min_ppn per net first, extras appended per net after.
    samples = np.random.normal(1.0 / num_nets,
                               1.0 / (params.net_distribution + 1), num_nets)
    probs = np.exp(samples) / np.sum(np.exp(samples))

    min_ppn = params.min_num_pins_per_net
    net_pins: List[List[CompatPin]] = []
    next_id = 0
    for n in range(num_nets):
        group = [CompatPin(pin_id=next_id + j, net_id=n)
                 for j in range(min_ppn)]
        next_id += min_ppn
        net_pins.append(group)

    extra = total_pins - min_ppn * num_nets
    if params.max_num_pins_per_net > min_ppn and extra > 0:
        alloc = _truncated_multinomial(
            num_nets, extra, probs,
            min(params.max_num_pins_per_net - min_ppn, extra))
        for n in range(num_nets):
            for _ in range(int(alloc[n])):
                net_pins[n].append(CompatPin(pin_id=next_id, net_id=n))
                next_id += 1

    # --- pins -> components (allocate_pins_to_components:1129-1169) --------
    if spatial:
        # dummy_env_rectangular_pin_spatial.py:1102-1104
        k0 = min(int((params.pin_spread / 10) * num_components) + 1,
                 num_components)
    else:
        # dummy_env_rectangular_pin.py:1148-1151
        k0 = min(max(int(((params.pin_spread + 1) / 10) * num_components), 1),
                 num_components)

    # ordered (comp_id, free_space) pairs standing in for the dict whose
    # insertion order carries across nets (the function returns the re-sorted
    # dict, so ties in net n+1 break by net n's sorted order)
    spaces: List[List[int]] = [[cid, areas[cid]]
                               for cid in range(num_components)]
    for n in range(num_nets):
        spaces.sort(key=lambda kv: kv[1], reverse=True)  # stable, like sorted()
        unassigned = len(net_pins[n])

        # grow the receiving set until its capacity covers the net (:1161-1173)
        k = k0 - 1
        capacity = 0
        while capacity < unassigned:
            k += 1
            capacity = sum(s for _, s in spaces[:k])

        ptr = 0
        while unassigned > 0:
            chosen = spaces[:k]
            tot = sum(s for _, s in chosen)
            counts = np.random.multinomial(
                unassigned, np.array([s / tot for _, s in chosen]))
            for entry, cnt in zip(chosen, counts):
                cnt = int(cnt)
                if entry[1] < cnt:
                    cnt = entry[1]          # cap at free space (:1252-1254)
                entry[1] -= cnt
                for j in range(cnt):
                    pin = net_pins[n][ptr + j]
                    if not spatial:
                        # PIN env rewrites pin_id per (component, round)
                        # chunk (:1256-1258); spatial keeps creation ids.
                        pin.pin_id = j
                    pin.comp_id = entry[0]
                ptr += cnt
                unassigned -= cnt

    # rebuilt self.pins: net-grouped (:1167-1169)
    pins: List[CompatPin] = [q for group in net_pins for q in group]

    # --- pin cells (place_pins_on_component:1478-1498) ----------------------
    # components processed in comp_id order; each consumes one random.choice
    # per owned pin from a shrinking row-major coordinate list
    by_comp: Dict[int, List[CompatPin]] = {cid: [] for cid in
                                           range(num_components)}
    for q in pins:
        by_comp[q.comp_id].append(q)
    for cid in range(num_components):
        coords = [(x, y) for x in range(comp_h[cid])
                  for y in range(comp_w[cid])]
        for q in by_comp[cid]:
            rc = random.choice(coords)
            coords.remove(rc)
            q.rel_x, q.rel_y = rc

    return CompatInstance(num_components=num_components, comp_h=comp_h,
                          comp_w=comp_w, num_nets=num_nets, pins=pins)


def generate_instance(params: EnvParams) -> CompatInstance:
    if params.variant == Variant.SQUARE:
        return generate_square_instance(params)
    if params.variant == Variant.RECT:
        return generate_rect_instance(params)
    return generate_pin_instance(params)
