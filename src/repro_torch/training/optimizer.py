"""AdamW, gradient clipping and the cosine schedule, on named tensors.

Port of ``repro/training/optimizer.py``: decoupled weight decay
(Loshchilov & Hutter) with bias correction, computed in float32
whatever the parameters' and moments' dtypes: each moment is stored in
its own dtype (float32, or bfloat16 with ``adamw_init(moments_dtype=)``)
and read back from what was stored, each parameter rounded to its
own.  It is not ``torch.optim.AdamW``, which
decays every tensor and orders its arithmetic differently: each step
here is the reference's expression for expression, so one update agrees
with it to float32 rounding.

Parameters, gradients and moments are dicts of name -> tensor (a
model's ``named_parameters()``, or plain tensors).  The reference
returns new pytrees; here the parameters and moments are updated in
place (no second copy of a multi-billion-parameter model), and the
functions run under ``torch.no_grad()``.

Weight decay follows the reference's leaf: ``_is_matrix`` decays a leaf
of rank >= 2.  Where a port tensor's rank differs from its JAX leaf's
(an LM group stacks its layers along a leading axis, so a stacked norm
scale is a matrix there), the caller passes the JAX ranks from
:func:`repro_torch.convert.reference_leaves`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor               # scalar int32
    mu: Dict[str, torch.Tensor]      # first moment, keyed like the params
    nu: Dict[str, torch.Tensor]      # second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params: Mapping[str, torch.Tensor],
               moments_dtype=torch.float32) -> AdamWState:
    """Zero moments beside each parameter (``moments_dtype=bfloat16``
    halves their memory; float32 is the training default)."""
    dev = next(iter(params.values())).device
    zeros = lambda: {n: torch.zeros(p.shape, dtype=moments_dtype,
                                    device=p.device)
                     for n, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(), nu=zeros())


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float, *,
                        square_sum: Optional[Callable] = None):
    """Scales ``grads`` in place to a global norm of at most ``max_norm``,
    the norm taken over every tensor in float32.  ``square_sum(grads)``,
    if given, returns the sum of squares in place of the local one (a
    sharded model's blocks count each whole tensor's elements once).
    Returns (grads, global_norm)."""
    if square_sum is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in grads.values()))
    else:
        gn = torch.sqrt(square_sum(grads))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        g.copy_(g.float() * scale)
    return grads, gn


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: AdamWState, *,
                 lr, cfg: AdamWConfig = AdamWConfig(),
                 leaf_ndim: Optional[Mapping[str, int]] = None):
    """One AdamW step, in place.  ``lr`` is a float or a scalar tensor
    (a schedule's value); ``leaf_ndim`` gives each parameter's rank in
    the reference's pytree (default: the tensor's own).  Returns
    (params, new state)."""
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    for name, p in params.items():
        gf = grads[name].float()
        m, v = state.mu[name], state.nu[name]
        m.copy_(b1 * m.float() + (1 - b1) * gf)
        v.copy_(b2 * v.float() + (1 - b2) * gf * gf)
        update = (m.float() / c1) / (torch.sqrt(v.float() / c2) + cfg.eps)
        ndim = p.dim() if leaf_ndim is None else leaf_ndim[name]
        if ndim >= 2:   # decay only matrices (norms/bias/scalars exempt)
            update = update + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * update)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_frac: float = 0.1):
    """Linear warmup -> cosine decay to ``min_frac * base_lr``; the
    returned ``lr_at(step)`` computes in float32, as the reference's."""

    def lr_at(step):
        s = torch.as_tensor(step).float()
        warm = base_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)

    return lr_at
