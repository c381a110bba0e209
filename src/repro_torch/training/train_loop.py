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

:func:`compile_train_step` is the port's ``jax.jit`` of a train step:
on the card it replays one CUDA graph per batch shape
(``repro_torch.runtime.graphs``), and everywhere else it calls the step.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.convert import reference_leaves
from repro_torch.runtime import graphs
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
                # no RNG state kept: nothing here draws random numbers,
                # and a CUDA graph may capture the step
                loss, metrics = torch.utils.checkpoint.checkpoint(
                    loss_fn, *args, use_reentrant=False,
                    preserve_rng_state=False)
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


# batch shapes a compiled train step keeps graphs of (the NMT trainer's
# padded_batches meet dozens; the reference's jit keeps every shape)
TRAIN_GRAPH_KEYS = 64


def compile_train_step(train_step: Callable, model) -> Callable:
    """The port's ``jax.jit(train_step)``: ``train_step(state, batch) ->
    (state, metrics)`` (``make_train_step``'s, or any step of that
    contract that updates the parameters and moments in place) replayed
    as one CUDA graph per batch key on the card.

    A key is the batch's names, shapes and dtypes and the state's
    parameter and moment dicts, at most ``TRAIN_GRAPH_KEYS`` of them,
    least recently used first out.  A key's first call captures the
    step over static batch buffers and the state's own tensors and makes
    that call a real step (``GraphCache.run_and_capture``: the first key
    runs it eagerly on the capture stream and hands the allocator's
    cached blocks, its gradients, back before the capture; a later key
    replays its graph once): nothing is saved or restored, so a step's
    peak stays near the eager one.  Each later call copies the batch in
    (one host-to-device copy an array) and replays.  The
    step counter is carried in the state's ``opt.step`` tensor, which
    every graph of the state shares (another counter tensor passed in
    is copied into it), so a schedule computes its ``lr`` in the graph
    from it.  The metrics returned are copies of the graph's outputs.

    A sharded LM's step is captured with its collectives (the weight
    gathers, their reduce_scatter in the backward, ``sync_grads``' and
    the norm's all_reduces; none on a mesh whose axes are all of size
    1).  On the CPU, under ``graphs.eager()`` and for a model whose
    ``graph_safe`` is False (the LM inside a sharded one) it calls
    ``train_step``."""
    cache = graphs.GraphCache(TRAIN_GRAPH_KEYS)

    def compiled(state: TrainState, batch):
        if not (graphs.active(model.device)
                and getattr(model, "graph_safe", True)):
            return train_step(state, batch)
        key = (tuple((k, tuple(np.shape(v)), str(getattr(v, "dtype", None)))
                     for k, v in sorted(batch.items()) if v is not None),
               id(state.params), id(state.opt.mu), id(state.opt.nu))
        entry = cache.peek(key)
        if entry is None:
            entry = cache.get(key, lambda: _TrainGraph(
                cache, train_step, state, batch, _counter(cache, state)))
            metrics = entry.first
        else:
            entry.load(state, batch)
            entry.graph.replay()
            metrics = _copies(entry.graph.outputs)
        return TrainState(entry.state.params, entry.state.opt), metrics

    compiled.graphs = cache
    return compiled


def _counter(cache: graphs.GraphCache, state: TrainState) -> torch.Tensor:
    """The step counter every graph of ``state``'s tensors shares: that
    of a graph made earlier over them, else the state's own."""
    for entry in cache.entries():
        if entry.state.params is state.params:
            return entry.step
    return state.opt.step


def _copies(metrics: dict) -> dict:
    """The metrics with every tensor copied out of the graph's pool."""
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


class _TrainGraph:
    """One batch key of a compiled train step: static batch buffers, the
    state over whose tensors the graph was captured (its counter shared),
    and the graph.  ``first`` is the metrics of the real first step."""

    def __init__(self, cache: graphs.GraphCache, train_step, state, batch,
                 step: torch.Tensor):
        params = next(iter(state.params.values()))
        self.batch = {k: torch.as_tensor(v, device=params.device).clone()
                      for k, v in batch.items() if v is not None}
        self.step = step
        if state.opt.step is not step:
            step.copy_(state.opt.step)
        self.state = TrainState(state.params, AdamWState(
            step=step, mu=state.opt.mu, nu=state.opt.nu))

        def body():
            new, metrics = train_step(self.state, self.batch)
            if new.opt.step is not step:
                step.copy_(new.opt.step)
            return metrics

        self.graph, self.first = cache.run_and_capture(
            body, static=(state.params, state.opt.mu, state.opt.nu, step),
            empty_cache=True)
        self.first = _copies(self.first)

    def load(self, state: TrainState, batch) -> None:
        if state.opt.step is not self.step:
            self.step.copy_(state.opt.step)
        for k, buf in self.batch.items():
            buf.copy_(graphs.host_tensor(batch[k]))

    def release(self) -> None:
        self.graph.release()
