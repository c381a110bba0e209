"""Multi-card dry-run: what one rank of an H100 mesh holds and moves for
each (architecture x input shape), with nothing allocated.

Port of ``repro/launch/dryrun.py``, with its names and CLI.  The
reference lowers and compiles the real step for 512 placeholder TPU
devices and reads XLA's ``memory_analysis``, ``cost_analysis`` and the
collectives of the partitioned HLO.  The port produces no HLO: its
sharded steps are PyTorch on each rank, replayed from CUDA graphs on
the card (:mod:`repro_torch.runtime.sharded`).  So each record is computed from
the sharding policy on an abstract mesh (:class:`MeshShape`: no process
group), the LM built on the ``meta`` device, and the port's own design:

* **Per-rank memory** (``memory``): argument bytes, exact from the
  specs, at the reference's dtypes (bfloat16 matrices, the leaves the
  reference keeps in float32 in float32; AdamW moments in bfloat16 at
  or above 100 B parameters, float32 below), in the terms of the step's
  arguments: parameters, moments and step counter (train), decode state
  (decode) and inputs.  XLA's ``temp_size_in_bytes`` has no counterpart
  without running the step, so it is left out, and ``fits_hbm``
  compares a lower bound (the arguments) with
  ``launch.mesh.H100["hbm_bytes"]``.
* **Analytic terms** (``analytic``): ``models.costs.step_cost`` for the
  whole mesh, as the reference uses it; :func:`roofline_terms` divides
  them over the ranks by the H100 data sheet's bf16 tensor-core rate and
  HBM bandwidth (``launch/mesh.py``).
* **Collectives** (``collectives``): the bytes the port's
  ``runtime/sharded.py`` moves per step, labelled as the port's: one
  all_gather of each module's blocks over the world per dtype among
  them (a flat buffer each: a bf16 block at 2 bytes a value), for
  training the gradients' reduce_scatter over the batch ranks (per
  dtype too), with ``remat`` each checkpointed layer's gather once more
  for its recompute, the replicated gradients' all_reduce (one per
  dtype), the norm's and the MoE load-balance means' all_reduces, and
  the loss's
  all_reduce of each cross entropy's token count and sum (each rank's
  logits stay its rows'); in serving, the last logits' gather over the
  batch axes; in decode, the gather of every split state
  leaf that is not a linear self-attention cache, and the
  sequence-sharded decode's two all_reduces per attention layer.  Bytes
  are each collective's result buffer on one rank (the reference counts
  the HLO result shapes).  The reference's HLO text parsers
  (``collective_stats`` and its helpers) are not ported: there is no HLO.

``--seq-parallel`` steers XLA only; it is accepted and recorded, and
changes none of these numbers.  ``remat`` (on unless ``--no-remat``) is
the port's ``LM(remat=True)``: a train record counts each checkpointed
layer's second weight gather; the argument bytes do not change.
``--flash-decode-sp`` is recorded too: the port's only decode path for
a linear cache split over its slots is the sequence-sharded one.
``--auto`` keeps the reference's rule (its TPU tuning).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \\
      --mesh pod1
  python -m repro_torch.launch.dryrun --all --mesh pod1 --out roofline/
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import traceback
from typing import Dict, List, Optional

import torch

from repro_torch.configs import (
    ARCH_NAMES,
    INPUT_SHAPES,
    get_config,
    shape_supported,
)
from repro_torch.launch.mesh import H100
from repro_torch.models.costs import step_cost
from repro_torch.models.model import LM
from repro_torch.sharding.policy import (
    MeshShape,
    ShardingPolicy,
    batch_specs,
    decode_state_specs,
    make_policy,
    param_specs,
    spec_axes,
)

PARAM_DTYPE = torch.bfloat16
# >=100B params: bf16 AdamW moments (the reference's memory knob)
BF16_MOMENTS_THRESHOLD = 100e9
# the reference's production meshes: one pod of 16 x 16, two pods
MESHES = {"pod1": MeshShape(("data", "model"), (16, 16)),
          "pod2": MeshShape(("pod", "data", "model"), (2, 16, 16))}
# the reference's --auto: ddp for these on train/prefill (TPU tuning)
SMALL_ARCHS = ("rwkv6-3b", "zamba2-1.2b", "whisper-large-v3")
_ATTENTION = ("attn", "shared_attn")


def input_specs(cfg, shape_name: str, *, model: LM) -> Dict:
    """Meta tensors standing in for every input of this shape (the
    reference's ``ShapeDtypeStruct`` stand-ins): tokens and targets for
    train, tokens for prefill (and frames for an encoder-decoder), the
    decode state at ``seq`` capacity and one token a row for decode."""
    seq, batch, kind = INPUT_SHAPES[shape_name]
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                            device="meta")
    i32 = torch.int32
    frames = (meta((batch, cfg.encoder.max_frames, cfg.d_model),
                   PARAM_DTYPE) if cfg.is_encoder_decoder else None)
    if kind == "train":
        tree = {"tokens": meta((batch, seq), i32),
                "targets": meta((batch, seq), i32)}
    elif kind == "prefill":
        tree = {"tokens": meta((batch, seq), i32)}
    elif kind == "decode":
        return {"state": model.init_decode_state(batch, seq,
                                                 dtype=PARAM_DTYPE),
                "tokens": meta((batch, 1), i32)}
    else:
        raise ValueError(kind)
    if frames is not None:
        tree["frames"] = frames
    return tree


# ---------------------------------------------------------- per rank --
def block_shape(shape, spec, pol: ShardingPolicy) -> tuple:
    """A rank's block of ``shape`` under ``spec``: each dim divided by the
    size of the axes its entry names (the policy names only axes that
    divide it)."""
    return tuple(n // pol.axis_size(spec_axes(e))
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _tree_leaves(tree, specs):
    """(tensor, spec) pairs of a tree of tensors and its spec tree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _tree_leaves(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for t, s in zip(tree, specs):
            yield from _tree_leaves(t, s)
    else:
        yield tree, specs


def _tree_bytes(tree, specs, pol) -> int:
    return sum(_nbytes(block_shape(t.shape, s, pol), t.dtype)
               for t, s in _tree_leaves(tree, specs))


def argument_bytes(model: LM, kind: str, inputs: Dict, pol: ShardingPolicy,
                   *, moments_dtype=torch.float32) -> Dict[str, int]:
    """One rank's bytes of the step's arguments (the reference's
    ``argument_size_in_bytes``), term by term: ``parameters`` (each at
    its dtype in ``model``);
    for train ``moments`` (mu and nu) and ``step`` (the int32 counter);
    for decode ``state``; ``inputs``; and their ``total``."""
    specs = param_specs(pol, model)
    out = {"parameters": sum(
        _nbytes(block_shape(p.shape, specs[n], pol), p.dtype)
        for n, p in model.named_parameters())}
    if kind == "train":
        out["moments"] = 2 * sum(
            _nbytes(block_shape(p.shape, specs[n], pol), moments_dtype)
            for n, p in model.named_parameters())
        out["step"] = 4
    if kind == "decode":
        state = inputs["state"]
        out["state"] = _tree_bytes(state, decode_state_specs(pol, state),
                                   pol)
        inputs = {"tokens": inputs["tokens"]}
    out["inputs"] = _tree_bytes(inputs, batch_specs(pol, inputs), pol)
    out["total"] = sum(out.values())
    return out


# ------------------------------------------------------- collectives --
def _gather_units(model: LM, kind: str) -> List[List]:
    """The modules the LM gathers together (one ``_whole`` context each),
    in the order a ``kind`` step runs them: the embedding, whisper's
    encoder layers and norm (train, prefill), every layer (a zamba2
    shared block once per shared group), the final norm with the head,
    and for deepseek-v3's MTP (train) the embedding, the MTP block and
    the head again."""
    cfg = model.cfg
    head = [model.final_norm,
            model.embed if cfg.tie_embeddings else model.lm_head]
    units = [[model.embed]]
    if cfg.is_encoder_decoder and kind != "decode":
        units += [[p] for p in model.encoder.layers]
        units.append([model.encoder.final_norm])
    units += [[p] for gi, g in enumerate(cfg.layer_plan)
              for p in model._layers(gi, g)]
    units.append(head)
    if kind == "train" and cfg.mtp_depth:
        units += [[model.embed], [model.mtp], head]
    return units


def _remat_units(model: LM) -> List[List]:
    """The units ``LM(remat=True)`` checkpoints, each re-gathered in the
    backward: every layer of a group but zamba2's shared block (not the
    encoder, the embedding, the head or the MTP block); none without
    ``remat``."""
    if not model.remat:
        return []
    return [[p] for gi, g in enumerate(model.cfg.layer_plan)
            if g.mixer != "shared_attn" for p in model.groups[gi]]


def _add(stats, op: str, nbytes: int, count: int = 1) -> None:
    stats[op]["bytes"] += nbytes
    stats[op]["count"] += count


def collective_bytes(model: LM, kind: str, inputs: Dict,
                     pol: ShardingPolicy) -> Dict:
    """The bytes one rank's collectives produce in one step of the port's
    sharded runtime (each collective's result buffer), by kind."""
    cfg = model.cfg
    stats = {op: {"bytes": 0, "count": 0}
             for op in ("all-gather", "reduce-scatter", "all-reduce")}
    world = math.prod(pol.mesh.sizes)
    specs = param_specs(pol, model)
    params = dict(model.named_parameters())
    names = {id(p): n for n, p in params.items()}
    cut = {n for n, s in specs.items()
           if any(pol.axis_size(spec_axes(e)) > 1 for e in s)}

    def block_bytes(names_, dtype=None):
        return sum(_nbytes(block_shape(params[n].shape, specs[n], pol),
                           dtype or params[n].dtype) for n in names_)

    batch_in = inputs["tokens"].shape[0]
    rows = pol.batch(batch_in)
    split = rows is not None and pol.axis_size(spec_axes(rows)) > 1

    def by_dtype(unit):
        """The bytes of a unit's cut blocks, one entry per dtype: one
        flat buffer (and collective) each."""
        unit_names = dict.fromkeys(
            names[id(p)] for mod in unit for p in mod.parameters())
        own: Dict[torch.dtype, int] = {}
        for n in unit_names:
            if n in cut:
                dt = params[n].dtype
                own[dt] = own.get(dt, 0) + block_bytes([n])
        return list(own.values())

    for unit in _gather_units(model, kind):
        for own in by_dtype(unit):
            _add(stats, "all-gather", world * own)
            if kind == "train" and split:
                _add(stats, "reduce-scatter", own)
    if kind == "train":
        # LM(remat=True): each checkpointed layer gathers its weights
        # again for its recompute in the backward
        for unit in _remat_units(model):
            for own in by_dtype(unit):
                _add(stats, "all-gather", world * own)
    b_loc = batch_in // (pol.axis_size(spec_axes(rows)) if split else 1)
    if split and kind != "train":
        _add(stats, "all-gather",
             _nbytes((batch_in, cfg.padded_vocab), model.param_dtype))
    if kind == "train":
        if split:
            # the loss: each cross entropy's token count and sum (float32)
            # over the batch ranks in one all_reduce; no logits move
            n_ce = 2 if cfg.mtp_depth else 1
            _add(stats, "all-reduce", 2 * n_ce * 4)
            rep = [n for n in specs if n not in cut]
            for dt in dict.fromkeys(params[n].dtype for n in rep):
                _add(stats, "all-reduce", block_bytes(
                    [n for n in rep if params[n].dtype == dt]))
            n_moe = sum(g.count for g in cfg.layer_plan if g.ffn == "moe")
            if n_moe:       # f_e and P_e, E float32 each, per MoE layer
                _add(stats, "all-reduce",
                     n_moe * 2 * 4 * cfg.moe.num_experts, 2 * n_moe)
        # the global norm: one float32 scalar per set of cutting axes
        axes_sets = {tuple(sorted({a for e in specs[n] for a in spec_axes(e)
                                   if pol.axis_size((a,)) > 1}))
                     for n in cut}
        _add(stats, "all-reduce", 4 * len(axes_sets), len(axes_sets))
    if kind == "decode":
        _decode_collectives(model, inputs["state"], pol, stats, b_loc)
    stats["total_bytes"] = sum(v["bytes"] for k, v in stats.items()
                               if isinstance(v, dict))
    return stats


def _decode_collectives(model, state, pol, stats, b_loc) -> None:
    """A decode step's state traffic: each split leaf that is not a
    linear self-attention cache is gathered for the step (its rows'
    whole tensor); each attention layer over a linear cache split over
    its slots runs two all_reduces (MAX of m (B, H), SUM of (o l w, l w)
    (B, H*Dh + H), float32)."""
    cfg = model.cfg
    specs = decode_state_specs(pol, state)
    w = cfg.sliding_window
    for g, cache, spec in zip(cfg.layer_plan, state["caches"],
                              specs["caches"]):
        for name, t in cache.items():
            beyond = [e if i != 1 else None for i, e in enumerate(spec[name])]
            if not any(pol.axis_size(spec_axes(e)) > 1 for e in beyond):
                continue
            if name in ("k", "v") and g.mixer in _ATTENTION \
                    and not g.cross_attn and not (w and t.shape[2] == w):
                if name == "k":
                    h = cfg.num_heads
                    _add(stats, "all-reduce", g.count * 4 * b_loc * (
                        h + h * cfg.head_dim + h), 2 * g.count)
                continue
            rows_whole = (t.shape[0], b_loc) + tuple(t.shape[2:])
            _add(stats, "all-gather", _nbytes(rows_whole, t.dtype))


# ----------------------------------------------------------- records --
def moments_dtype(cfg) -> torch.dtype:
    return (torch.bfloat16
            if cfg.param_counts()["total"] >= BF16_MOMENTS_THRESHOLD
            else torch.float32)


def analyze(arch: str, shape_name: str, mesh_name: str, *, remat=True,
            layout: str = "tp", seq_parallel: bool = False,
            flash_decode_sp: bool = False, fsdp: bool = True) -> dict:
    """The record of one (architecture, shape, mesh): what one rank
    holds (``memory``), the analytic step cost (``analytic``) and the
    port's collective bytes (``collectives``)."""
    mesh = MESHES[mesh_name]
    n_chips = math.prod(mesh.sizes)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": n_chips, "layout": layout, "seq_parallel": seq_parallel,
           "flash_decode_sp": flash_decode_sp, "fsdp": fsdp,
           "remat": remat, "ok": False}
    ok, reason = shape_supported(arch, shape_name)
    if not ok:
        rec["skipped"] = reason
        return rec
    cfg = get_config(arch, shape=shape_name)
    seq, batch, kind = INPUT_SHAPES[shape_name]
    pol = make_policy(mesh, batch_size=batch, layout=layout, fsdp=fsdp)
    model = LM(cfg, device="meta", param_dtype=PARAM_DTYPE, remat=remat)
    inputs = input_specs(cfg, shape_name, model=model)
    moments = moments_dtype(cfg)
    args = argument_bytes(model, kind, inputs, pol, moments_dtype=moments)
    rec["memory"] = {
        "argument_size_in_bytes": args["total"],
        "argument_terms": args,
        "temp_size_in_bytes": None,
        "per_device_total": args["total"],
        "fits_hbm": bool(args["total"] <= H100["hbm_bytes"]),
        "note": ("arguments only, a lower bound: temporaries have no "
                 "counterpart without running the step; fits_hbm compares "
                 "that bound with launch.mesh.H100['hbm_bytes']"),
    }
    rec["collectives"] = collective_bytes(model, kind, inputs, pol)
    rec["collectives"]["source"] = (
        "the port's runtime/sharded.py design (result bytes per rank), "
        "not the reference's partitioned HLO")
    rec["xla_only_flags"] = ("seq_parallel steers XLA; it changes none "
                             "of these numbers")

    pc = cfg.param_counts()
    tokens = batch * seq if kind != "decode" else batch
    rec["params_total"] = pc["total"]
    rec["params_active"] = pc["active"]
    rec["tokens_per_call"] = tokens
    rec["model_flops"] = float((6 if kind == "train" else 2)
                               * pc["active"] * tokens)
    sc = step_cost(cfg, kind=kind, batch=batch, seq=seq,
                   moments_bytes=2 if moments == torch.bfloat16 else 8)
    rec["analytic"] = {"flops": sc.flops, "hbm_bytes": sc.hbm_bytes}
    rec["ok"] = True
    return rec


def roofline_terms(rec: dict) -> dict:
    """The three roofline terms, in seconds per step, on H100s: the
    analytic whole-mesh FLOPs over the ranks at the bf16 tensor-core rate
    (``peak_flops_bf16``), the analytic bytes over the ranks at the HBM
    bandwidth (``hbm_bw``), and one rank's collective bytes at the NVLink
    rate (``nvlink_bw``, each way; links between hosts are slower, so
    this term is a lower bound past one host)."""
    n = rec["chips"]
    flops = rec.get("analytic", {}).get("flops", 0.0) / n
    bytes_ = rec.get("analytic", {}).get("hbm_bytes", 0.0) / n
    coll = rec.get("collectives", {}).get("total_bytes", 0)
    t_compute = flops / H100["peak_flops_bf16"]
    t_memory = bytes_ / H100["hbm_bw"]
    t_coll = coll / H100["nvlink_bw"]
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))
    return {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "dominant": dom[1],
        "rates": {"compute": "peak_flops_bf16", "memory": "hbm_bw",
                  "collective": "nvlink_bw"},
        "useful_flops_ratio": (rec["model_flops"] / rec["analytic"]["flops"]
                               if rec.get("analytic", {}).get("flops")
                               else None),
    }


def auto_settings(arch: str, shape: str, layout: str, fsdp: bool,
                  flash_decode_sp: bool):
    """The reference's ``--auto`` rule, its TPU tuning kept as it is:
    decode keeps FSDP only where a model-axis shard of the bf16 weights
    exceeds 4.5 GB and takes the split-cache decode; the small
    architectures train and prefill under ``ddp``.  Returns (layout,
    fsdp, flash_decode_sp)."""
    if INPUT_SHAPES[shape][2] == "decode":
        tp_shard_gb = get_config(arch).param_counts()["total"] * 2 / 16 / 1e9
        return layout, tp_shard_gb > 4.5, True
    if arch in SMALL_ARCHS:
        return "ddp", fsdp, flash_decode_sp
    return layout, fsdp, flash_decode_sp


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES))
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=list(MESHES), default="pod1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="roofline")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--layout", choices=["tp", "ddp"], default="tp")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--flash-decode-sp", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--auto", action="store_true",
                    help="the reference's per-combination settings: ddp "
                         "for the small archs on train/prefill, FSDP only "
                         "past a 4.5 GB shard and the split-cache decode "
                         "for decode")
    ap.add_argument("--tag-suffix", default="")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    combos = ([(a, s) for a in ARCH_NAMES for s in INPUT_SHAPES]
              if args.all else [(args.arch, args.shape)])
    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for arch, shape in combos:
        layout, fsdp, fdsp = (args.layout, not args.no_fsdp,
                              args.flash_decode_sp)
        if args.auto:
            layout, fsdp, fdsp = auto_settings(arch, shape, layout, fsdp,
                                               fdsp)
        tag = f"{arch}_{shape}_{args.mesh}{args.tag_suffix}"
        try:
            rec = analyze(arch, shape, args.mesh, remat=not args.no_remat,
                          layout=layout, seq_parallel=args.seq_parallel,
                          flash_decode_sp=fdsp, fsdp=fsdp)
            if rec["ok"]:
                rec["roofline"] = roofline_terms(rec)
        except Exception as e:      # one combination's failure is recorded
            rec = {"arch": arch, "shape": shape, "mesh": args.mesh,
                   "ok": False, "error": str(e),
                   "traceback": traceback.format_exc()}
            n_fail += 1
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        status = ("SKIP " + rec.get("skipped", "")) if "skipped" in rec else \
            ("OK" if rec.get("ok") else "FAIL " + rec.get("error", "")[:200])
        print(f"[dryrun] {tag}: {status}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
