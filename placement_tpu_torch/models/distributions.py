"""Action distributions as functions of logits (port of
``placement_tpu/models/distributions.py``).

Reference: utils/agent/factorized_action_distributions.py — ``Categorical``
(:21-104) and the two factorized distributions (:107-458 orientation order
o->x->y, :461-818 coordinate order x->y->o). Every function takes the whole
batch; random draws come from an explicit ``torch.Generator`` by Gumbel-max
(JAX's ``jax.random`` stream is not reproduced: samples are held to JAX by
distribution, the ``argmax`` path exactly). A masked logit sits at f32's
lowest value, which no Gumbel draw lifts above a legal one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from placement_tpu_torch.models.blocks import mask_logits as _mask

F32 = torch.float32
I64 = torch.int64

#: ``(r, n)``: a rank's block r of n equal row blocks of a batch
Shard = Tuple[int, int]


# ---------------------------------------------------------------------------
# Categorical (factorized_action_distributions.py:21-104)
# ---------------------------------------------------------------------------

def cat_sample(gen: torch.Generator, logits: torch.Tensor,
               shard: Optional[Shard] = None) -> torch.Tensor:
    """One draw per row of ``logits`` [B, ..., A] (Gumbel-max, as
    ``jax.random.categorical``). ``shard=(r, n)``: ``logits`` are block r
    of n equal row blocks of a batch, and the uniforms are drawn at the
    whole batch's shape and block r kept, so that n ranks draw what one
    process draws."""
    if shard is None:
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
    else:
        r, n = shard
        b = logits.shape[0]
        u = torch.rand((n * b,) + logits.shape[1:], generator=gen,
                       device=logits.device)[r * b:(r + 1) * b]
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(F32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def cat_argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def cat_logp(logits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, x.to(I64)[..., None])[..., 0]


def cat_entropy(logits: torch.Tensor) -> torch.Tensor:
    a0 = logits - logits.max(dim=-1, keepdim=True).values
    ea0 = torch.exp(a0)
    z0 = ea0.sum(dim=-1, keepdim=True)
    p0 = ea0 / z0
    return (p0 * (torch.log(z0) - a0)).sum(dim=-1)


def cat_kl(logits_p: torch.Tensor, logits_q: torch.Tensor) -> torch.Tensor:
    a0 = logits_p - logits_p.max(dim=-1, keepdim=True).values
    a1 = logits_q - logits_q.max(dim=-1, keepdim=True).values
    ea0, ea1 = torch.exp(a0), torch.exp(a1)
    z0 = ea0.sum(dim=-1, keepdim=True)
    z1 = ea1.sum(dim=-1, keepdim=True)
    p0 = ea0 / z0
    return (p0 * (a0 - torch.log(z0) - a1 + torch.log(z1))).sum(dim=-1)


# ---------------------------------------------------------------------------
# Factorized distributions
# ---------------------------------------------------------------------------

class FactorizedHeads(NamedTuple):
    """Per-factor logit functions over a fixed encoding, with the
    factorized model heads' signatures
    (rectangle_model_factorized.py:133-311):

      o(enc, x_norm, y_norm) — x/y ignored under "orientation" ordering
      x(enc, onehot_o)       — onehot ignored under "coordinates"
      y(enc, onehot_o, x_norm)
    """

    o: Callable
    x: Callable
    y: Callable
    num_orientations: int
    height: int
    width: int


def _rows(mask: torch.Tensor, i: torch.Tensor, dim: int) -> torch.Tensor:
    """mask[b, ..., i[b], ...] along ``dim`` (>= 1): the board's slice at
    its own index."""
    shape = list(mask.shape)
    shape[dim] = 1
    idx = i.to(I64).view((-1,) + (1,) * (mask.dim() - 1)).expand(shape)
    return mask.gather(dim, idx).squeeze(dim)


def _onehot_o(o: torch.Tensor, n: int) -> torch.Tensor:
    return (o.to(I64)[..., None] == torch.arange(n, device=o.device)).to(F32)


class Factorized:
    """Hierarchical masked categorical over (orientation, x, y); ``mask``
    is the f32 action mask [B, O, H, W].

    order="orientation": p(o) p(x|o) p(y|o,x)  (reference class at :107)
    order="coordinates": p(x) p(y|x) p(o|x,y)  (reference class at :461)
    """

    def __init__(self, heads: FactorizedHeads, enc: torch.Tensor,
                 mask: torch.Tensor, order: str):
        self.heads = heads
        self.enc = enc
        self.mask = mask
        self.order = order

    # -- per-factor logits -------------------------------------------------

    def _logits_chain_orientation(self, o: Optional[torch.Tensor] = None,
                                  x: Optional[torch.Tensor] = None
                                  ) -> Tuple:
        """(:352-358, :393-401, :440-448)"""
        h, m = self.heads, self.mask
        o_logits = _mask(h.o(self.enc, None, None), m.amax(dim=(2, 3)))
        x_logits = y_logits = None
        if o is not None:
            plane = _rows(m, o, 1)                          # [B, H, W]
            oh = _onehot_o(o, h.num_orientations)
            x_logits = _mask(h.x(self.enc, oh), plane.amax(dim=2))
            if x is not None:
                x_norm = x.to(F32) / h.height               # :438 x / num_x
                y_logits = _mask(h.y(self.enc, oh, x_norm),
                                 _rows(plane, x, 1))
        return o_logits, x_logits, y_logits

    def _logits_chain_coordinates(self, x: Optional[torch.Tensor] = None,
                                  y: Optional[torch.Tensor] = None
                                  ) -> Tuple:
        """(:700-718, :760-768, :798-808)"""
        h, m = self.heads, self.mask
        x_logits = _mask(h.x(self.enc, None), m.amax(dim=(1, 3)))
        y_logits = o_logits = None
        if x is not None:
            cols = _rows(m, x, 2)                           # [B, O, W]
            x_norm = x.to(F32) / h.height
            y_logits = _mask(h.y(self.enc, None, x_norm), cols.amax(dim=1))
            if y is not None:
                y_norm = y.to(F32) / h.width
                o_logits = _mask(h.o(self.enc, x_norm, y_norm),
                                 _rows(cols, y, 2))
        return x_logits, y_logits, o_logits

    # -- API ---------------------------------------------------------------

    def _chain(self, dist: "Factorized" = None):
        """``dist``'s (default this one's) logits chain in this one's factor
        order: ``chain(first, second)`` -> the three factors' logits, the
        later ones None while their conditioning factors are."""
        d = dist or self
        return (d._logits_chain_orientation if self.order == "orientation"
                else d._logits_chain_coordinates)

    def _to_oxy(self, f: Tuple) -> torch.Tensor:
        """The factors in drawing order -> (o, x, y) [B, 3]."""
        oxy = f if self.order == "orientation" else (f[2], f[0], f[1])
        return torch.stack(oxy, dim=-1)

    def sample(self, gen: torch.Generator, deterministic: bool = False,
               shard: Optional[Shard] = None) -> torch.Tensor:
        """(o, x, y) i64[B, 3], each factor drawn given the earlier ones
        (``argmax`` of each when ``deterministic``); ``shard`` as in
        ``cat_sample``, here and below."""
        def pick(lg):
            return (cat_argmax(lg) if deterministic
                    else cat_sample(gen, lg, shard))

        chain = self._chain()
        a = pick(chain()[0])
        b = pick(chain(a)[1])
        return self._to_oxy((a, b, pick(chain(a, b)[2])))

    def logp(self, actions: torch.Tensor) -> torch.Tensor:
        o, x, y = actions[..., 0], actions[..., 1], actions[..., 2]
        f = (o, x, y) if self.order == "orientation" else (x, y, o)
        return sum(cat_logp(lg, v)
                   for lg, v in zip(self._chain()(f[0], f[1]), f))

    def entropy(self, gen: torch.Generator, shard: Optional[Shard] = None
                ) -> torch.Tensor:
        """Stochastic factor-sum entropy: later factors condition on a fresh
        sample of the earlier ones, as in the reference (:233-254)."""
        chain = self._chain()
        first = chain()[0]
        a = cat_sample(gen, first, shard)
        second = chain(a)[1]
        third = chain(a, cat_sample(gen, second, shard))[2]
        return cat_entropy(first) + cat_entropy(second) + cat_entropy(third)

    def kl(self, other: "Factorized", gen: torch.Generator,
           shard: Optional[Shard] = None) -> torch.Tensor:
        """Stochastic factor-sum KL (:257-283): both distributions' factors
        at the same samples of this one's earlier factors."""
        chain, o_chain = self._chain(), self._chain(other)
        first = chain()[0]
        a = cat_sample(gen, first, shard)
        second = chain(a)[1]
        b = cat_sample(gen, second, shard)
        return (cat_kl(first, o_chain()[0]) + cat_kl(second, o_chain(a)[1])
                + cat_kl(chain(a, b)[2], o_chain(a, b)[2]))
