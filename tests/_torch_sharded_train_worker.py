"""One rank of ``tests/test_torch_sharded_train.py``'s 4-process gloo run.

    python tests/_torch_sharded_train_worker.py RANK WORLD WORKDIR

Reads ``WORKDIR/inputs.pt`` (the port's seeded weights, three batches a
model, the cases), joins the process group through ``WORKDIR/pg`` (60 s
timeout), builds a (2, 2) ``("data", "model")`` mesh, and for each case
shards the LM, runs three train steps through ``make_train_step`` and
records the losses, grad norms, each rank's block shapes and (rank 0)
the parameters and both moments gathered whole; the same for bf16 models
(bf16 or float32 moments, with and without ``LM(remat=True)``).  Then
the MoE
load-balance loss and this rank's logits of one sharded forward, the
metrics of ``lm_loss`` over a masked batch, and a sharded checkpoint:
written by ``save_train_state``, read back into a fresh sharded state.
Writes what it saw to ``WORKDIR/out_RANK.pt``; imports torch and the
port only.
"""

import datetime
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.runtime.sharded import shard_lm  # noqa: E402
from repro_torch.training.checkpoint import (  # noqa: E402
    load_train_state,
    save_train_state,
)
from repro_torch.training.losses import lm_loss  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    init_train_state,
    make_train_step,
)


def _lm(name, inputs, seed=0, dtype=torch.float32, remat=False):
    """A smoke LM: float32 with the parent's weights (seed 0), or drawn
    here from ``seed`` (bf16 from seed 0 is the parent's bf16 model)."""
    model = LM(smoke_config(name), device="cpu", seed=seed,
               param_dtype=dtype, remat=remat)
    if seed == 0 and dtype == torch.float32:
        model.load_state_dict(inputs["weights"][name], strict=True)
    return model


def _whole(lm, state, rank):
    """The state's parameters and moments gathered whole (a collective),
    kept by rank 0 only."""
    tensors = {key: lm.whole_tensors(t) for key, t in (
        ("params", state.params), ("mu", state.opt.mu),
        ("nu", state.opt.nu))}
    if rank:
        return None
    return {key: {n: t.detach().clone() for n, t in ts.items()}
            for key, ts in tensors.items()}


def _train(name, layout, inputs, mesh, rank, workdir, *,
           dtype=torch.float32, moments=torch.float32, remat=False,
           ckpt=False):
    lm, pol = shard_lm(_lm(name, inputs, dtype=dtype, remat=remat), mesh,
                       batch_size=4, layout=layout)
    state = init_train_state(lm, moments_dtype=moments)
    step = make_train_step(lm)
    rec = {"loss": [], "grad_norm": [], "aux": [],
           "layout": "tp" if pol.model_axes else "ddp",
           "local_shapes": {n: tuple(p.shape)
                            for n, p in state.params.items()},
           "moment_shapes": {n: tuple(t.shape)
                             for n, t in state.opt.mu.items()}}
    for batch in inputs["batches"][name]:
        state, m = step(state, batch)
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        rec["aux"].append(float(m["aux"]))
    rec["step"] = int(state.opt.step)
    rec["whole"] = _whole(lm, state, rank)
    if ckpt:
        path = os.path.join(workdir, "sharded.npz" if dtype == torch.float32
                            else "sharded_bfloat16.npz")
        save_train_state(path, lm, state, step=rec["step"])
        fresh, _ = shard_lm(_lm(name, inputs, seed=1, dtype=dtype), mesh,
                            batch_size=4, layout=layout)
        loaded = load_train_state(path, fresh, init_train_state(
            fresh, moments_dtype=moments))
        rec["loaded"] = _whole(fresh, loaded, rank)
        rec["loaded_step"] = int(loaded.opt.step)
    return rec


def main(rank: int, world: int, workdir: str) -> None:
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'pg')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    mesh = make_host_mesh((2, 2), ("data", "model"), "cpu")
    out = {"coord": tuple(mesh.get_coordinate()), "train": {}}
    for name, layout in inputs["train_cases"]:
        out["train"][(name, layout)] = _train(
            name, layout, inputs, mesh, rank, workdir,
            ckpt=(name, layout) == inputs["ckpt_case"])
    # bf16: (name, layout, moments dtype, remat); the first case also
    # checkpoints its sharded state
    out["bf16"] = {}
    for i, (name, layout, moments, remat) in enumerate(
            inputs["bf16_cases"]):
        out["bf16"][(name, layout, remat)] = _train(
            name, layout, inputs, mesh, rank, workdir, dtype=torch.bfloat16,
            moments=moments, remat=remat, ckpt=i == 0)
    lm, _ = shard_lm(_lm("qwen3-moe-30b-a3b", inputs), mesh, batch_size=4,
                     layout="tp")
    with torch.no_grad():
        logits_out = lm.train_logits(torch.as_tensor(inputs["aux_tokens"]))
        out["aux_loss"] = float(logits_out["aux_loss"])
        out["logits"] = logits_out["logits"].clone()
        aux_batch = {"tokens": torch.as_tensor(inputs["aux_tokens"]),
                     "targets": torch.as_tensor(inputs["aux_targets"]),
                     "mask": torch.as_tensor(inputs["aux_mask"])}
        _, metrics = lm_loss(lm, aux_batch)
        out["loss_metrics"] = {k: float(v) for k, v in metrics.items()}
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
