"""Train-step factory: loss -> grads -> clip -> AdamW.

Port of ``repro/training/train_loop.py``.  The reference's state holds
the parameter pytree; the port's holds the model's parameters by name
(the same tensors the model computes with, updated in place), so a
train step needs no copy of the weights.

As the reference jits one ``make_train_step`` under ``train_state_specs``
shardings, the port's takes a
:class:`~repro_torch.runtime.sharded.ShardedLM` as it takes an LM: the
state's parameters and both moments are then this rank's blocks, each
rank calls the step with the whole batch and runs its rows, the loss is
the whole batch's, each gradient is summed over the batch shards onto
the rank's block, the global norm counts every element once, and AdamW
updates the blocks (the step counter is replicated).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.convert import reference_leaves
from repro_torch.training.losses import lm_loss
from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
)


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt: AdamWState


def init_train_state(model, moments_dtype=torch.float32) -> TrainState:
    """The model's parameters, unfrozen (the port's models are built
    frozen), and zero AdamW moments in ``moments_dtype`` (the caller's
    choice, as in the reference: float32 by default, bfloat16 halves
    them; the dry run picks bf16 at or above 100 B parameters).  The
    weights are the model's own, drawn at construction (the reference
    draws them here from a key); a sharded LM's are this rank's blocks,
    and so are its moments."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return TrainState(params=params,
                      opt=adamw_init(params, moments_dtype=moments_dtype))


def leaf_ndims(model) -> Dict[str, int]:
    """Each parameter's rank in the reference's pytree: the rank
    :func:`adamw_update`'s weight-decay rule reads."""
    leaves = reference_leaves(model)
    return {name: leaves[name].ndim(p)
            for name, p in model.named_parameters()}


def apply_gradients(params: Dict[str, torch.Tensor], loss: torch.Tensor,
                    opt: AdamWState, *, lr, cfg: AdamWConfig,
                    leaf_ndim: Dict[str, int], model=None):
    """The body of every train step here: grads of ``loss`` (zeros for a
    parameter it does not reach, as ``jax.grad`` gives) -> clip -> AdamW.
    A sharded ``model`` (one with ``sync_grads``) sums the replicated
    parameters' gradients over its batch shards and takes the global
    norm over the whole tensors.  Returns (params, new opt state, global
    grad norm)."""
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names],
                                allow_unused=True)
    grads = {n: torch.zeros_like(params[n]) if g is None else g
             for n, g in zip(names, grads)}
    sync = getattr(model, "sync_grads", None)
    if sync is not None:
        sync(grads)
    grads, gnorm = clip_by_global_norm(
        grads, cfg.clip_norm,
        square_sum=getattr(model, "grad_square_sum", None))
    params, opt = adamw_update(params, grads, opt, lr=lr, cfg=cfg,
                               leaf_ndim=leaf_ndim)
    return params, opt, gnorm


def make_train_step(model, *, lr_schedule: Optional[Callable] = None,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    remat: bool = False) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics) for an LM or
    a :class:`~repro_torch.runtime.sharded.ShardedLM` (every rank calls
    the step with the whole batch: a collective).

    ``batch`` holds numpy arrays or tensors ({"tokens", "targets"[,
    "mask", "frames"]}: an encoder-decoder's frames go to its encoder).
    ``remat=True`` wraps the loss in ``torch.utils.checkpoint`` (its
    activations are recomputed in the backward instead of kept), as
    ``jax.checkpoint`` does; the model's own ``LM(remat=True)``
    checkpoints each layer instead.

    The model is float32 or bfloat16 (``LM(param_dtype=)``), with the
    reference's dtype rules: each gradient in its parameter's dtype, the
    global norm in float32 and each clipped gradient rounded back to its
    dtype, AdamW computing in float32 and storing the moments in
    ``init_train_state``'s ``moments_dtype`` and each parameter in its
    own, the cross entropy on float32 logits."""
    if model.param_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"make_train_step trains a float32 or bfloat16 "
                         f"model, not {model.param_dtype}")
    ndims = leaf_ndims(model)

    keys = ("tokens", "targets", "mask", "frames")

    def loss_fn(*args):
        batch = {k: a for k, a in zip(keys, args) if a is not None}
        loss, metrics = lm_loss(model, batch)
        return loss, metrics

    def train_step(state: TrainState, batch):
        args = [None if batch.get(k) is None
                else torch.as_tensor(batch[k], device=model.device)
                for k in keys]
        with torch.enable_grad():
            if remat:
                loss, metrics = torch.utils.checkpoint.checkpoint(
                    loss_fn, *args, use_reentrant=False)
            else:
                loss, metrics = loss_fn(*args)
            lr = (lr_schedule(state.opt.step) if lr_schedule is not None
                  else opt_cfg.lr)
            params, opt, gnorm = apply_gradients(
                state.params, loss, state.opt, lr=lr, cfg=opt_cfg,
                leaf_ndim=ndims, model=model)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_norm=gnorm, lr=lr)
        return TrainState(params=params, opt=opt), metrics

    return train_step
