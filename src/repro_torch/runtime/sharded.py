"""Mesh-backed serving for the big-LM stack.

Port of ``repro/runtime/sharded.py``: a
:class:`~repro_torch.runtime.serving.GenerationSession` /
:class:`~repro_torch.runtime.serving.ContinuousGenerationSession` whose LM
parameters and decode state lie over a ``torch.distributed``
``DeviceMesh`` (a gloo mesh of CPU processes in tests, NCCL across cards),
under the reference's partition specs (``sharding/policy.py``), so a
:class:`~repro_torch.runtime.engine.Tier` of the ``CollaborativeEngine``
can be a multi-device LM server: a sharded tier is just a tier.

The reference leaves execution to GSPMD.  Here every rank runs the
port's unchanged layer code on its own part of the work:

* **Parameters.**  Each is held as a ``DTensor`` under
  ``to_placements(param_specs(...))``: the module keeps only this rank's
  block, and a layer's weights are gathered whole just before it runs
  (one all_gather of its blocks per dtype: a bf16 layer's matrices as
  bf16, its float32 norms or router in a second buffer) and freed after
  it (``LM.unshard``), as FSDP does.  A weight whose spec splits nothing
  (or only over size-1 axes) is never gathered.
* **Batch.**  Each rank runs the rows ``batch_specs`` gives it; logits are
  gathered over the batch axes, so every rank returns the whole batch
  and the sessions' token loops run the same on every rank.
* **Prefill** computes on the rank's rows with gathered weights; the rank
  then keeps only its block of every state leaf (``decode_state_specs``).
  The state carries its specs under ``"specs"``.
* **Decode.**  Self-attention over a linear cache split over its sequence
  axis runs ``attn_decode_seq_sharded`` on the rank's slots (a
  :class:`~repro_torch.sharding.ctx.SeqShard` installed for the step).
  Any other leaf split beyond the batch (a ring cache, a cross-attention
  group's self-attention cache, MLA's ``ckv``/``kpe``, ``ssm``/``wkv``
  heads over ``model``) is gathered for the step and cut back after it.
* **Training** (``training.train_loop`` takes a :class:`ShardedLM` as it
  takes an LM; the state holds this rank's blocks and their moments).
  The weight gather is differentiable (:class:`_Gather`): its backward
  sums each whole-size gradient over the ranks that split the batch and
  cuts it to the rank's block, in one reduce_scatter a module per dtype,
  as FSDP does.  A gradient is reduced in its parameter's dtype: a bf16
  matrix's in bf16, as the reference's partitioned bf16 step reduces it
  (its AdamW then computes in float32 on the bf16 sum).  Every rank
  computes the same whole-batch loss on the gathered logits, so the
  logits' gather only slices its gradient.  A weight no
  spec cuts has its gradient all-reduced over the batch ranks
  (:meth:`ShardedLM.sync_grads`); ranks that share rows compute it
  redundantly and are not added.  The global norm sums each block's
  squares over the axes that cut it, and only those
  (:meth:`ShardedLM.grad_square_sum`).  The MoE load-balance loss, a
  product of two token means, takes both means over the whole batch
  (a :class:`~repro_torch.sharding.ctx.BatchShard` installed for the
  forward; a layer checkpointed by ``LM(remat=True)`` re-enters it for
  its recompute and gathers its weights again there).

**CUDA graphs.**  A sharded LM is ``graph_safe``: on the card its
sessions replay one graph a decode step, prefill block and admission
wave, and ``compile_train_step`` one a train step, as for an LM
(``runtime/graphs.py``), the collectives captured inside:

* *Storage.*  A graph replays the addresses it captured, so every leaf
  of a sharded decode state keeps its storage: ``decode_step`` copies
  the block of a leaf it gathered back into the leaf, ``prefill(into=)``
  writes each block in place and ``copy_rows`` indexes in place.
* *No host work.*  ``copy_rows`` decides on the device which entries
  this rank holds (``src_rows=``: a wave's static indices); ``_gather``
  is plain ``all_gather_into_tensor`` on the mesh's groups and
  ``_block`` a view, not DTensor's collectives.
* *The stream.*  Captures run on ``graphs``' capture stream.  A c10d
  NCCL collective runs on the process group's own stream, which waits
  on an event of the current (capturing) stream and is waited on by it,
  so it joins the capture; the work it returns is not queued to the
  watchdog while the stream captures (torch 2.11 + CUDA 12.8 on H100s:
  1-rank groups, and 4 ranks on a (2, 2) mesh with every collective of
  the sessions and the train step, ``scripts/sharded_graphs_cards.py``).
* *Communicators.*  NCCL makes a group's at its first collective, which
  a capture cannot hold; the constructor runs one on the world, each
  mesh dimension's group and each group it makes, on every rank in the
  same order.
* *Order.*  Every rank makes the same calls on the whole batch, so the
  sessions' shape keys, captures and replays line up across ranks
  (``launch/serve.py --mesh``: rank 0 drives, the others follow its
  broadcast calls).
* *``flash_decode``'s split counters* are allocated at a device's first
  call, which a capture's eager warm-up makes; every graph is captured
  on the one capture stream and replayed on the current stream, one at
  a time, as an LM's.
* *Pools.*  A sharded LM's session graphs share its LM's pool
  (``graph_pool_owner``), so a model served sharded and unsharded keeps
  one.
* *Teardown.*  NCCL destroys a communicator only once every graph that
  captured one of its collectives is gone (on 4 cards
  ``destroy_process_group`` waited past a 600 s deadline with the
  graphs alive): ``graphs.release_all()`` first, as ``launch/serve.py
  --mesh`` does.

A 1x1 mesh keeps its size-1 axes: ``tp`` still decodes through
``attn_decode_seq_sharded``, two one-rank all_reduces a layer, captured.

Tokens equal the unsharded session's only behind a top-2 logit margin: a
rank computes B/|batch axes| rows, so a GEMM's kernel and
``flash_decode``'s split plan change with the batch shape, and the
sequence-sharded merge sums in another order (ROADMAP C).  In bfloat16
the merge takes each rank's partial output as the kernel rounded it to
bf16 and rounds the float32 merge once more (the unsharded kernel rounds
once): on one rank that gives back the kernel's output exactly (the
merge moves a float32 value by less than half a bf16 step), so a 1x1
mesh decodes bitwise as the unsharded model; across ranks the tokens are
held behind bf16's wider margin.  MoE decode
dispatches the rank's rows as one group, so with a capacity factor that
drops assignments a row's output depends on which rows share its rank.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.runtime.serving import (
    ContinuousGenerationSession,
    GenerationSession,
)
from repro_torch.sharding.ctx import (
    BatchShard,
    SeqShard,
    set_batch_shard,
    set_decode_seq_shard,
)
from repro_torch.sharding.policy import (
    ShardingPolicy,
    decode_state_specs,
    make_policy,
    mesh_shape,
    param_specs,
    spec_axes,
    to_placements,
)

_ATTENTION = ("attn", "shared_attn")


def infer_layout(cfg, mesh) -> str:
    """Pick the policy layout for this architecture on this mesh.

    ``tp`` when the attention head counts divide the ``model`` axis (the
    split then divides real work); ``ddp`` otherwise, and for mixers that
    carry no head axis worth splitting (rwkv6, mamba2)."""
    tp = int(mesh_shape(mesh).shape.get("model", 1))
    if tp <= 1:
        return "ddp"
    heads_ok = (cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0)
    has_heads = any(g.mixer in ("attn", "shared_attn", "mla")
                    for g in cfg.layer_plan)
    return "tp" if (has_heads and heads_ok) else "ddp"


def _leaves(state):
    """(parent, key, batch axis) of each tensor of a decode state (or of
    its spec tree): cache leaves have the batch at axis 1, after the layer
    axis; ``pos`` and ``enc_mask`` at axis 0."""
    for cache in state["caches"]:
        for name in cache:
            yield cache, name, 1
    for name in ("pos", "enc_mask"):
        if name in state:
            yield state, name, 0


def _keep(spec, axis: int, keep: bool):
    """``spec`` with only entry ``axis`` (keep) or all but it (not keep)."""
    return tuple(e if (i == axis) == keep else None
                 for i, e in enumerate(spec))


class _Gather(torch.autograd.Function):
    """The whole tensors of ``params`` (this rank's blocks) in one
    all_gather over the world; backward: each whole-size gradient summed
    over ``group`` (the ranks that split the rows of the call, None if
    none did) and cut to this rank's block, in one reduce_scatter.
    ``DTensor.full_tensor``'s backward would only cut the gradient: right
    for a value every rank computes whole, wrong for a weight that two
    batch shards both used."""

    @staticmethod
    def forward(ctx, lm, params, group, *blocks):
        ctx.lm, ctx.params, ctx.group = lm, params, group
        return tuple(lm._gather_blocks(params, blocks))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(
            ctx.lm._reduce_blocks(ctx.params, grads, ctx.group))


class ShardedLM:
    """An :class:`~repro_torch.models.model.LM` over ``mesh`` under
    ``policy``, with the LM's serving interface (``prefill``,
    ``decode_step``, ``init_decode_state``, ``copy_rows``,
    ``train_logits``, ``cfg``, ``device``) and what the train step reads
    (``named_parameters``, ``requires_grad_``, ``sync_grads``,
    ``grad_square_sum``).  Every call is a collective: each rank calls it
    with the whole batch; serving calls return the whole batch's logits,
    ``train_logits`` this rank's rows'.  The LM
    given is changed in place (its parameters become this rank's
    blocks)."""

    # a CUDA graph captures its steps, collectives included (module doc)
    graph_safe = True

    def __init__(self, model, mesh, policy: ShardingPolicy):
        if model.param_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"a sharded LM must be float32 or bfloat16, "
                             f"not {model.param_dtype}")
        backend = dist.get_backend()
        if model.device.type != mesh.device_type:
            raise ValueError(f"the model lies on {model.device.type}, the "
                             f"mesh on {mesh.device_type}")
        if model.device.type == "cuda" and "nccl" not in backend:
            raise ValueError(f"a model on cuda needs an NCCL process group, "
                             f"not {backend}")
        if math.prod(mesh.shape) != dist.get_world_size():
            raise ValueError(f"a {tuple(mesh.shape)} mesh does not cover the "
                             f"{dist.get_world_size()} ranks")
        self.model, self.mesh, self.policy = model, mesh, policy
        self.cfg = model.cfg
        # the mesh coordinate of each global rank, in rank order
        self._coords = [tuple((mesh.mesh == r).nonzero()[0].tolist())
                        for r in range(mesh.mesh.numel())]
        self._coord = self._coords[dist.get_rank()]
        self.specs = param_specs(policy, model)
        self._dtensors: Dict[int, DTensor] = {}
        for name, p in model.named_parameters():
            spec = self.specs[name]
            local = self._block(p.data, spec)
            p.data = local
            self._dtensors[id(p)] = DTensor.from_local(
                local, mesh, to_placements(mesh, spec), run_check=False)
        # the groups a train step reduces over: the batch axes', and each
        # set of axes that cuts a parameter (created here, on every rank
        # in the same order, as new groups must be)
        self._groups: Dict[Tuple[str, ...], object] = {}
        for axes in [self._cut_axes((policy.batch_axes,))] + [
                self._cut_axes(spec) for spec in self.specs.values()]:
            if axes and axes not in self._groups:
                self._groups[axes] = self._new_group(axes)
        # every communicator a call may use, made now, on every rank in
        # the same order: NCCL makes a group's at its first collective,
        # which must not fall inside a CUDA graph capture
        for group in [None, *map(mesh.get_group, mesh.mesh_dim_names),
                      *self._groups.values()]:
            dist.all_reduce(torch.zeros(1, device=model.device), group=group)
        self._grad_group = None      # the batch group of the last forward
        self._train_rows = None      # and its batch spec entry
        model.unshard = self._unshard

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def param_dtype(self) -> torch.dtype:
        return self.model.param_dtype

    @property
    def graph_pool_owner(self):
        """The LM whose graph pool this model's session graphs share
        (``graphs.owner_cache``): one pool for the model, sharded or
        not."""
        return self.model

    def local_bytes(self) -> int:
        """Bytes of the parameter blocks this rank holds."""
        return sum(dt.to_local().nbytes for dt in self._dtensors.values())

    def named_parameters(self):
        """The LM's parameters: this rank's blocks."""
        return self.model.named_parameters()

    def requires_grad_(self, flag: bool = True):
        self.model.requires_grad_(flag)
        return self

    # ---------------------------------------------------------- groups --
    def _cut_axes(self, spec) -> Tuple[str, ...]:
        """The mesh axes of size > 1 that ``spec`` names, in mesh order."""
        named = {a for e in spec for a in spec_axes(e)}
        return tuple(a for a in self.mesh.mesh_dim_names
                     if a in named and self.policy.axis_size((a,)) > 1)

    def _new_group(self, axes):
        """The process group of the ranks that share this rank's
        coordinates off ``axes`` (created for every such set of ranks)."""
        names = self.mesh.mesh_dim_names
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        grid = self.mesh.mesh.permute(*rest, *dims).reshape(
            -1, self.policy.axis_size(axes))
        group, _ = dist.new_subgroups_by_enumeration(grid.tolist())
        return group

    def _group(self, axes):
        """The group over ``axes`` (a spec entry or a tuple of names);
        None where they span one rank."""
        return self._groups.get(self._cut_axes((axes,)))

    # ---------------------------------------------------------- blocks --
    def _splits(self, spec) -> bool:
        """Whether ``spec`` cuts a tensor (an axis of size 1 cuts nothing)."""
        return bool(self._cut_axes(spec))

    def _block_view(self, t, spec):
        """This rank's block of the whole tensor ``t`` under ``spec``, as
        a view: each dim cut into equal blocks over its mesh dimensions in
        mesh order, as ``distribute_tensor`` lays blocks out (no
        collective, no host work: a graph may capture it)."""
        for md, pl in enumerate(to_placements(self.mesh, spec)):
            n = self.mesh.shape[md]
            if pl.is_shard() and n > 1:
                size = t.shape[pl.dim] // n
                t = t.narrow(pl.dim, self._coord[md] * size, size)
        return t

    def _block(self, t, spec):
        """This rank's block of the whole tensor ``t`` (a contiguous copy)
        under ``spec``; ``t`` itself where the spec cuts nothing."""
        if not self._splits(spec):
            return t
        return self._block_view(t, spec).clone(
            memory_format=torch.contiguous_format)

    def _gather(self, t, spec):
        """The whole tensor from each rank's block ``t`` under ``spec``:
        one all_gather over each mesh dimension that cuts it, the last
        first, laid out as ``DTensor.full_tensor`` lays it (plain
        ``all_gather_into_tensor`` calls on the mesh's groups, which a
        CUDA graph captures on NCCL); ``t`` itself where the spec cuts
        nothing."""
        if not self._splits(spec):
            return t
        placements = to_placements(self.mesh, spec)
        for md in reversed(range(len(placements))):
            pl, n = placements[md], self.mesh.shape[md]
            if not pl.is_shard() or n == 1:
                continue
            t = t.contiguous()
            parts = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
            dist.all_gather_into_tensor(parts, t,
                                        group=self.mesh.get_group(md))
            t = torch.cat(parts.view((n,) + tuple(t.shape)).unbind(0),
                          dim=pl.dim)
        return t

    def _rows(self, t, rows):
        """This rank's rows of a whole-batch tensor; None stays None."""
        if t is None:
            return None
        t = torch.as_tensor(t, device=self.device)
        return self._block(t, (rows,) + (None,) * (t.dim() - 1))

    @contextlib.contextmanager
    def _unshard(self, *modules):
        """``modules``' parameters whole while the block runs (gathered
        tensors stand in for the parameters in their modules, through
        :class:`_Gather`, so a train step's backward reaches the blocks),
        then the blocks again (the gathered copies are freed)."""
        cut, seen = [], set()
        for mod in modules:
            for owner in mod.modules():
                for name, p in owner._parameters.items():
                    if isinstance(p, nn.Parameter) and id(p) not in seen \
                            and p.shape != self._dtensors[id(p)].shape:
                        seen.add(id(p))
                        cut.append((owner, name, p))
        params = [p for _, _, p in cut]
        wholes = _Gather.apply(self, params, self._grad_group,
                               *params) if params else ()
        for (owner, name, _), whole in zip(cut, wholes):
            owner._parameters[name] = whole
        try:
            yield
        finally:
            for owner, name, p in cut:
                owner._parameters[name] = p

    def _region(self, p, coord):
        """The slices of ``p``'s whole tensor that the rank at mesh
        coordinate ``coord`` holds, as ``DTensor`` lays blocks out: a dim
        split over several mesh dims takes them in mesh order."""
        dt = self._dtensors[id(p)]
        index = [0] * dt.dim()
        for md, pl in enumerate(dt.placements):
            if pl.is_shard():
                index[pl.dim] = index[pl.dim] * self.mesh.shape[md] + coord[md]
        return tuple(slice(i * n, (i + 1) * n)
                     for i, n in zip(index, dt.to_local().shape))

    def _gather_blocks(self, params, blocks):
        """The whole tensors of ``params`` from each rank's ``blocks`` of
        them (the blocks themselves, or tensors laid out alike: AdamW's
        moments) in one all_gather over the world per dtype among the
        blocks: a flat buffer of every block of that dtype, as FSDP
        gathers a layer (a bf16 block crosses as 2 bytes a value)."""
        out = [None] * len(params)
        for idx in _by_dtype(blocks):
            flat = torch.cat([blocks[i].reshape(-1) for i in idx])
            parts = [torch.empty_like(flat) for _ in self._coords]
            dist.all_gather(parts, flat)
            off = 0
            for i in idx:
                p, b = params[i], blocks[i]
                whole = b.new_empty(self._dtensors[id(p)].shape)
                for part, coord in zip(parts, self._coords):
                    whole[self._region(p, coord)] = \
                        part[off:off + b.numel()].view(b.shape)
                out[i] = whole
                off += b.numel()
        return out

    def _reduce_blocks(self, params, grads, group):
        """This rank's block of each whole-size gradient in ``grads``
        (None: zeros), summed over ``group`` in one reduce_scatter per
        dtype of a flat buffer holding each member's blocks in turn (a
        bf16 gradient is summed in bf16); only cut to the block where
        ``group`` is None (every rank saw every row)."""
        grads = [torch.zeros(self._dtensors[id(p)].shape, dtype=p.dtype,
                             device=p.device) if g is None else g
                 for p, g in zip(params, grads)]
        if group is None:
            return [g[self._region(p, self._coord)].clone()
                    for p, g in zip(params, grads)]
        members = dist.get_process_group_ranks(group)
        out = [None] * len(params)
        for idx in _by_dtype(grads):
            chunks = [torch.cat([
                grads[i][self._region(params[i], self._coords[q])]
                .reshape(-1) for i in idx]) for q in members]
            flat = torch.empty_like(chunks[0])
            dist.reduce_scatter(flat, chunks, group=group)
            off = 0
            for i in idx:
                p = params[i]
                out[i] = flat[off:off + p.numel()].view(p.shape).to(p.dtype)
                off += p.numel()
        return out

    # -------------------------------------------------------- training --
    def sync_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """All-reduce (sum, in place) the gradients of the parameters no
        spec cuts over the ranks that split the last forward's rows, one
        all_reduce per dtype (bf16 gradients summed in bf16); the cut
        ones arrive summed from :class:`_Gather`'s backward."""
        if self._grad_group is None:
            return
        names = [n for n in grads if not self._splits(self.specs[n])]
        for idx in _by_dtype([grads[n] for n in names]):
            flat = torch.cat([grads[names[i]].reshape(-1) for i in idx])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                            group=self._grad_group)
            off = 0
            for i in idx:
                g = grads[names[i]]
                g.copy_(flat[off:off + g.numel()].view(g.shape))
                off += g.numel()

    def grad_square_sum(self, grads: Dict[str, torch.Tensor]):
        """The sum of squares of the whole gradients whose blocks are
        ``grads`` (float32): each block's squares summed over the ranks
        that hold the tensor's other blocks (the axes its spec cuts), and
        only those."""
        by_axes: Dict[Tuple[str, ...], list] = {}
        for name, g in grads.items():
            by_axes.setdefault(self._cut_axes(self.specs[name]), []).append(
                torch.sum(torch.square(g.float())))
        total = None
        for axes, sums in by_axes.items():
            part = sum(sums)        # in order, as the unsharded norm sums
            if axes:
                dist.all_reduce(part, op=dist.ReduceOp.SUM,
                                group=self._groups[axes])
            total = part if total is None else total + part
        return total

    def whole_tensors(self, blocks: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """The whole tensors of ``blocks`` (keyed by parameter name, laid
        out as the parameters' blocks: the parameters or their moments),
        in one all_gather per dtype.  A collective."""
        names = [n for n in blocks if self._splits(self.specs[n])]
        params = dict(self.model.named_parameters())
        out = dict(blocks)
        with torch.no_grad():
            out.update(zip(names, self._gather_blocks(
                [params[n] for n in names], [blocks[n] for n in names])))
        return out

    def block_of(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of parameter ``name``'s whole tensor (a
        copy, on the model's device)."""
        p = dict(self.model.named_parameters())[name]
        return whole.to(self.device)[self._region(p, self._coord)].clone()

    # ----------------------------------------------------------- state --
    def _split_state(self, state, batch: int):
        """Keep this rank's block of every leaf of a decode state whose
        rows are already this rank's (``batch`` rows in all)."""
        shapes = {"caches": [{name: _meta(t, 1, batch)
                              for name, t in cache.items()}
                             for cache in state["caches"]]}
        shapes.update({name: _meta(state[name], 0, batch)
                       for name in ("pos", "enc_mask") if name in state})
        specs = decode_state_specs(self.policy, shapes)
        for (parent, name, axis), (sp, _, _) in zip(_leaves(state),
                                                    _leaves(specs)):
            parent[name] = self._block(parent[name],
                                       _keep(sp[name], axis, False))
        state["specs"] = specs
        return state

    def init_decode_state(self, batch: int, max_len: int, dtype=None, *,
                          ring: bool = True) -> Dict:
        """``LM.init_decode_state`` of the whole batch, this rank's block."""
        rows = self.policy.batch(batch)
        n = batch // (self.policy.axis_size(rows) if rows else 1)
        return self._split_state(
            self.model.init_decode_state(n, max_len, dtype, ring=ring), batch)

    # --------------------------------------------------------- serving --
    @torch.no_grad()
    def prefill(self, tokens, *, frames=None, frame_mask=None, window=None,
                max_len=None, lengths=None, check: bool = True,
                into: Optional[Dict] = None):
        """``LM.prefill`` of the whole batch: (logits (B,V) whole, this
        rank's block of the decode state).  ``check`` and ``into`` mean
        what they mean to ``LM.prefill``: ``into`` (a sharded decode state
        of the shapes this call returns, its ``"specs"`` included) takes
        this rank's block of every leaf in place and is returned."""
        b = tokens.shape[0]
        rows = self.policy.batch(b)
        cut = [] if into is None else [
            (parent, name, _keep(sp[name], axis, False))
            for (parent, name, axis), (sp, _, _) in zip(
                _leaves(into), _leaves(into["specs"]))]
        # a state whose leaves are cut only by rows is written in place;
        # another is made whole on the rank's rows and cut into ``into``
        whole_into = into is not None and not any(
            self._splits(spec) for _, _, spec in cut)
        logits, state = self.model.prefill(
            self._rows(tokens, rows), frames=self._rows(frames, rows),
            frame_mask=self._rows(frame_mask, rows), window=window,
            max_len=max_len, lengths=self._rows(lengths, rows), check=check,
            into=into if whole_into else None)
        logits = self._gather(logits, (rows, None))
        if into is None:
            return logits, self._split_state(state, b)
        if not whole_into:
            for (parent, name, spec), (fresh, fname, _) in zip(
                    cut, _leaves(state)):
                parent[name].copy_(self._block_view(fresh[fname], spec))
        return logits, into

    @torch.no_grad()
    def decode_step(self, state: Dict, tokens):
        """``LM.decode_step`` of the whole batch on this rank's block of
        the state, updated in place (every leaf keeps its storage: a leaf
        gathered for the step gets its block of the result copied back);
        returns the whole batch's logits."""
        specs = state["specs"]
        rows = specs["pos"][0]
        w = self.cfg.sliding_window
        gathered, seq_axes = [], None
        for g, cache, spec in zip(self.cfg.layer_plan, state["caches"],
                                  specs["caches"]):
            for name, t in cache.items():
                cut = _keep(spec[name], 1, False)
                if not any(spec_axes(e) for e in cut):
                    continue
                if name in ("k", "v") and g.mixer in _ATTENTION \
                        and not g.cross_attn and not (w and t.shape[2] * (
                            self.policy.axis_size(spec_axes(cut[2]))) == w):
                    # a linear self-attention cache: decoded where it lies
                    seq_axes = spec_axes(cut[2])
                    continue
                cache[name] = self._gather(t, cut)
                gathered.append((cache, name, cut, t))
        seq = None
        if seq_axes is not None:
            (axis,) = seq_axes        # the policy splits a sequence one way
            seq = SeqShard(self.mesh.get_group(axis), axis, spec_axes(rows))
        set_decode_seq_shard(seq)
        try:
            logits, _ = self.model.decode_step(state,
                                               self._rows(tokens, rows))
        finally:
            set_decode_seq_shard(None)
        for cache, name, cut, block in gathered:
            block.copy_(self._block_view(cache[name], cut))
            cache[name] = block
        return self._gather(logits, (rows, None)), state

    def _block_index(self, entry) -> int:
        """The index of this rank's block along a dim that spec entry
        ``entry`` cuts (its mesh dimensions in mesh order)."""
        names = spec_axes(entry)
        index = 0
        for md, axis in enumerate(self.mesh.mesh_dim_names):
            if axis in names:
                index = index * self.mesh.shape[md] + self._coord[md]
        return index

    def copy_rows(self, dst: Dict, src: Dict, slots, src_rows=None) -> None:
        """``LM.copy_rows`` between two sharded states: each rank gathers
        ``src``'s rows (its own block of the other axes) and writes those
        of the slots it holds.  ``slots`` is a list of whole-table slots
        (``src``'s first rows), or with ``src_rows`` two long tensors on
        the device (a CUDA graph's static indices; two entries may name
        one slot if they name one row).

        Everything is decided on the device: this rank holds the slots
        ``[base, base + n)`` of its block, and an entry naming a slot of
        another rank's writes where and what this rank's first held entry
        writes (the same bits twice, as a wave's padding row does), or,
        where this rank holds none of the slots, row 0's own values back."""
        dev = self.device
        if src_rows is None:
            slots = torch.as_tensor(slots, dtype=torch.long, device=dev)
            src_rows = torch.arange(slots.shape[0], device=dev)
        n = dst["pos"].shape[0]
        local = slots - self._block_index(dst["specs"]["pos"][0]) * n
        held = (local >= 0) & (local < n)
        first = torch.argmax(held.to(torch.int32)).view(1)
        some = held.any()
        at = torch.where(held, local, torch.where(
            some, local.index_select(0, first), torch.zeros_like(local)))
        pick = torch.where(held, src_rows, src_rows.index_select(0, first))
        for (dp, name, axis), (sp, _, _), (fp, _, _), (fsp, _, _) in zip(
                _leaves(dst), _leaves(dst["specs"]), _leaves(src),
                _leaves(src["specs"])):
            if _keep(sp[name], axis, False) != _keep(fsp[name], axis, False):
                raise ValueError(f"{name}: the states split it differently")
            fresh = self._gather(fp[name], _keep(fsp[name], axis, True))
            t = dp[name]
            t.index_copy_(axis, at, torch.where(
                some, fresh.index_select(axis, pick),
                t.index_select(axis, at)))

    @property
    def batch_group(self):
        """The ranks that split the rows of the last ``train_logits``
        (None where every rank ran every row)."""
        return self._grad_group

    def local_rows(self, t):
        """This rank's rows of a whole-batch tensor (targets, a mask) in
        the last ``train_logits``' split; None stays None."""
        return self._rows(t, self._train_rows)

    def train_logits(self, tokens, *, frames=None, frame_mask=None):
        """``LM.train_logits`` of the whole batch, each rank on its rows:
        the logits (and ``mtp_logits``) are this rank's rows
        (:meth:`local_rows` cuts the targets alike; nothing gathers
        them), ``aux_loss`` is the whole batch's (the load-balance means
        are taken over the ranks that split the rows).  Differentiable: a
        loss of the outputs reaches this rank's parameter blocks, summed
        over the ranks that split the rows (see :class:`_Gather`), so a
        loss term over rows is this rank's rows' share of the whole
        batch's (``training.losses.lm_loss``)."""
        rows = self.policy.batch(tokens.shape[0])
        self._train_rows = rows
        self._grad_group = group = self._group(rows)
        if group is not None:
            set_batch_shard(BatchShard(group, self.policy.axis_size(
                spec_axes(rows))))
        try:
            out = self.model.train_logits(
                self._rows(tokens, rows), frames=self._rows(frames, rows),
                frame_mask=self._rows(frame_mask, rows))
        finally:
            set_batch_shard(None)
        return out


def _by_dtype(tensors):
    """The indices of ``tensors`` grouped by dtype, each group in order
    and the groups in order of first appearance: one flat buffer and one
    collective per group (``torch.cat`` would promote bf16 blocks beside
    float32 ones to float32, twice the bytes on the wire)."""
    groups: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _meta(t, axis: int, n: int):
    """A meta tensor of ``t``'s shape with ``n`` at ``axis``."""
    shape = list(t.shape)
    shape[axis] = n
    return torch.empty(shape, device="meta")


def shard_lm(model, mesh, *, batch_size: int = 8, layout: str = "auto",
             fsdp: bool = True) -> Tuple[ShardedLM, ShardingPolicy]:
    """Place ``model`` (an LM, built the same on every rank) on ``mesh``
    under the sharding policy.  Returns ``(sharded_lm, policy)``;
    ``layout="auto"`` delegates to :func:`infer_layout`."""
    if layout == "auto":
        layout = infer_layout(model.cfg, mesh)
    pol = make_policy(mesh, batch_size=batch_size, layout=layout, fsdp=fsdp)
    return ShardedLM(model, mesh, pol), pol


def make_sharded_session(model, mesh, *, continuous: bool = False,
                         batch_size: int = 8, layout: str = "auto",
                         fsdp: bool = True, max_len: int = 64,
                         max_slots: int = 8, bucket_shapes: bool = True,
                         host_loop: bool = False):
    """A generation session over ``model`` sharded on ``mesh``.

    ``continuous=False`` returns a :class:`GenerationSession`,
    ``continuous=True`` a :class:`ContinuousGenerationSession`
    (decoder-only plans).  ``build_executor``, ``Tier`` and
    ``CollaborativeEngine.serve_continuous`` compose unchanged.  Every
    rank makes the same calls on the session (each is a collective);
    ``launch/serve.py --mesh`` has rank 0 drive it and the others follow.
    The session carries ``.policy``, ``.layout`` and ``.mesh``."""
    lm, pol = shard_lm(model, mesh, batch_size=batch_size, layout=layout,
                       fsdp=fsdp)
    if continuous:
        sess = ContinuousGenerationSession(lm, max_slots=max_slots,
                                           max_len=max_len,
                                           bucket_shapes=bucket_shapes)
    else:
        sess = GenerationSession(lm, max_len=max_len, host_loop=host_loop)
    sess.policy = pol
    sess.layout = "tp" if pol.model_axes else "ddp"
    sess.mesh = mesh
    return sess
