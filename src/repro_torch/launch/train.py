"""The training entry point of the big-LM stack.

    python -m repro_torch.launch.train --arch zamba2-1.2b --smoke \\
        --device cpu --steps 20

Port of ``repro/launch/train.py`` for the nine decoder-only
architectures (``--smoke`` for the reduced same-family configuration).
whisper-large-v3 is refused: its loss needs frames, and the reference's
launcher (like this one) feeds a token stream only.  On the card it
refuses a full-width configuration whose float32 parameters, gradients
and two AdamW moments (16 bytes a parameter) exceed the card's memory:
qwen3-8b's take ≈131 GB, and every larger model's more.  The loss is
``lm_loss``'s: cross entropy, the MoE load-balance term and, for
deepseek-v3-671b, the MTP cross entropy.  Weights
are drawn from seed 0; the data is the reference's: a uniform random
token stream packed by ``lm_batches``; AdamW under a cosine schedule with
a tenth of the steps warming up; a checkpoint of the ``TrainState`` in
the reference's format if ``--ckpt`` is given.  As the reference jits
its step, the step is compiled (``compile_train_step``: one CUDA graph
of the one batch shape, replayed every step; eager on the CPU and under
``graphs.eager()``).  It runs on ``cuda`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import lm_batches
from repro_torch.device import resolve_device
from repro_torch.models.model import LM
from repro_torch.models.registry import resolve
from repro_torch.training.checkpoint import save_train_state
from repro_torch.training.optimizer import AdamWConfig, cosine_schedule
from repro_torch.training.train_loop import (
    compile_train_step,
    init_train_state,
    make_train_step,
)


TRAIN_BYTES_PER_PARAM = 16   # float32 parameter, gradient, two moments


def check_fits(arch: str, device_bytes: int) -> None:
    """Raise ``ValueError`` if training ``arch`` at full width needs more
    than ``device_bytes`` for its parameters, gradients and AdamW moments
    (counted on the ``meta`` device: nothing is allocated)."""
    n = sum(p.numel() for p in LM(get_config(arch), device="meta")
            .parameters())
    need = TRAIN_BYTES_PER_PARAM * n
    if need > device_bytes:
        raise ValueError(
            f"training {arch} at full width needs {need / 1e9:.1f} GB for "
            f"its {n / 1e9:.2f}B float32 parameters, their gradients and "
            f"two AdamW moments; the card has {device_bytes / 1e9:.1f} GB "
            "(use --smoke)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    arch = args.arch.replace("_", "-")
    if get_config(arch).is_encoder_decoder:
        raise ValueError(
            f"{arch!r} is an encoder-decoder: its loss needs frames, and "
            "this launcher, like the reference's repro.launch.train, feeds "
            "a token stream only (train it through training.lm_loss with "
            "batch['frames'])")
    dev = resolve_device(args.device)
    if not args.smoke and dev.type == "cuda":
        check_fits(arch, torch.cuda.get_device_properties(dev).total_memory)
    r = resolve(arch, size="smoke" if args.smoke else "full",
                device=args.device, seed=0)
    model, cfg = r.model, r.cfg
    state = init_train_state(model)
    sched = cosine_schedule(args.lr, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps)
    step_fn = compile_train_step(make_train_step(
        model, lr_schedule=sched, opt_cfg=AdamWConfig(lr=args.lr)), model)

    rng = np.random.default_rng(0)
    stream = rng.integers(1, cfg.vocab_size,
                          args.steps * args.batch * (args.seq + 1) * 2
                          ).astype(np.int32)
    t0, losses = time.time(), []
    for i, batch in enumerate(lm_batches(stream, batch_size=args.batch,
                                         seq_len=args.seq)):
        if i >= args.steps:
            break
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if i % 10 == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f}", flush=True)
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"in {time.time() - t0:.0f}s")
    if args.ckpt:
        save_train_state(args.ckpt, model, state, step=args.steps)
        print(f"checkpoint: {args.ckpt}")
    return losses


if __name__ == "__main__":
    main()
