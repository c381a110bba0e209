"""The training entry point of the big-LM stack.

    python -m repro_torch.launch.train --arch zamba2-1.2b --smoke \\
        --device cpu --steps 20

Port of ``repro/launch/train.py`` for the two families the port has,
``rwkv6-3b`` and ``zamba2-1.2b`` (``--smoke`` for the reduced
same-family configuration); the other architectures wait for their
model families.  Weights are drawn from seed 0; the data is the
reference's: a uniform random token stream packed by ``lm_batches``;
AdamW under a cosine schedule with a tenth of the steps warming up; a
checkpoint of the ``TrainState`` in the reference's format if
``--ckpt`` is given.  It runs on ``cuda`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import PORTED
from repro_torch.data.pipeline import lm_batches
from repro_torch.models.registry import resolve
from repro_torch.training.checkpoint import save_checkpoint, state_to_jax
from repro_torch.training.optimizer import AdamWConfig, cosine_schedule
from repro_torch.training.train_loop import (
    TrainState,
    init_train_state,
    make_train_step,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
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
    if arch not in PORTED:
        raise NotImplementedError(
            f"LM training for {arch!r} waits for its model family in the "
            f"port (ROADMAP A.4/A.5); trainable now: {', '.join(PORTED)}")
    r = resolve(arch, size="smoke" if args.smoke else "full",
                device=args.device, seed=0)
    model, cfg = r.model, r.cfg
    state = init_train_state(model)
    sched = cosine_schedule(args.lr, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps)
    step_fn = make_train_step(model, lr_schedule=sched,
                              opt_cfg=AdamWConfig(lr=args.lr))

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
        params, opt = state_to_jax(model, state.params, state.opt)
        save_checkpoint(args.ckpt, TrainState(params, opt), step=args.steps)
        print(f"checkpoint: {args.ckpt}")
    return losses


if __name__ == "__main__":
    main()
