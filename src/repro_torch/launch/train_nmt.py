"""Train one of the paper's NMT models on the synthetic parallel corpus.

    python -m repro_torch.launch.train_nmt --device cpu --steps 60
    python -m repro_torch.launch.train_nmt --model marian --pair en-zh \\
        --full-width --batch 32 --steps 200

Port of ``examples/train_nmt.py``, with the same pipeline: the corpus
from ``make_corpus(pair, 4000, seed=0, with_tokens=True)`` (token ids
clipped into the model's vocabulary), ``padded_batches`` at ``max_len``
48 reshuffled each pass, the loss through the model's differentiable
training path, gradient clipping, AdamW (lr 3e-4, weight decay 0.01)
under a cosine schedule with 20 warm-up steps, a checkpoint in the
reference's format, and the same final check: the mean loss of the last
10 steps is below that of the first 10.  As the example jits its step,
the step (the schedule's ``lr`` from the device's step counter, the
loss, its gradients, clipping and AdamW) is compiled
(``compile_train_step``): on the card one CUDA graph per batch shape,
and ``padded_batches`` pads each batch to its own widths, so a run meets
many; eager on the CPU and under ``graphs.eager()``.

``--model`` picks the family (default: the example's own small Marian,
d_model 128, on the de-en corpus); ``--full-width`` builds it at the
paper's widths (``repro_torch.nmt.registry.PAPER_MODELS``: Marian 512 x 8
heads x 2048, 6+6 layers; BiLSTM 2 x 500; GRU 1 x 256; vocabulary
8000).  It runs on ``cuda`` unless given ``--device cpu``.
``REPRO_SMOKE=1`` defaults to 60 steps, as the example's smoke run.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.data.pipeline import padded_batches
from repro_torch.data.synthetic import make_corpus
from repro_torch.device import resolve_device
from repro_torch.models.registry import nmt_config
from repro_torch.nmt import (
    BiLSTMSeq2Seq,
    GRUSeq2Seq,
    MarianTransformer,
    RNNConfig,
    TransformerConfig,
)
from repro_torch.nmt.registry import PAPER_MODELS
from repro_torch.training.checkpoint import save_checkpoint, state_to_jax
from repro_torch.training.optimizer import AdamWConfig, cosine_schedule
from repro_torch.training.train_loop import (
    TrainState,
    apply_gradients,
    compile_train_step,
    init_train_state,
    leaf_ndims,
)

MODELS = {"marian": MarianTransformer, "gru": GRUSeq2Seq,
          "bilstm": BiLSTMSeq2Seq}
# the example's Marian, and RNNs of the same small width
SMALL = {
    "marian": TransformerConfig(vocab_src=512, vocab_tgt=512, d_model=128,
                                heads=4, d_ff=256, enc_layers=2,
                                dec_layers=2, max_decode_len=64,
                                max_src_len=64),
    "gru": RNNConfig(vocab_src=512, vocab_tgt=512, embed=128, hidden=128,
                     layers=1, max_decode_len=64),
    "bilstm": RNNConfig(vocab_src=512, vocab_tgt=512, embed=128, hidden=128,
                        layers=2, max_decode_len=64),
}
OPT = AdamWConfig(lr=3e-4, weight_decay=0.01)
WARMUP = 20
MAX_LEN = 48


def build_model(family: str, *, full_width: bool = False, device=None,
                seed: int = 0):
    """``family`` at the example's small width, or at the paper's."""
    if full_width:
        pair = next(p for p, (fam, _, _) in PAPER_MODELS.items()
                    if fam == family)
        cfg = nmt_config(pair, scale=1.0)
    else:
        cfg = SMALL[family]
    return MODELS[family](cfg, device=device, seed=seed)


def corpus_tokens(pair: str, cfg, size: int = 4000):
    """The pair's synthetic corpus, token ids clipped into the model's
    vocabularies (as the example clips them)."""
    corpus = make_corpus(pair, size, seed=0, with_tokens=True)
    src = [np.minimum(s, cfg.vocab_src - 1) for s in corpus.src]
    tgt = [np.minimum(t, cfg.vocab_tgt - 1) for t in corpus.tgt]
    return src, tgt


def batches(src, tgt, *, batch: int, max_len: int = MAX_LEN):
    """``padded_batches`` passes over the corpus without end, pass ``it``
    shuffled with seed ``it`` (the step count at its start), as the
    example's loop does."""
    it = 0
    while True:
        for b in padded_batches(src, tgt, batch_size=batch, max_len=max_len,
                                seed=it):
            yield b
            it += 1


def make_nmt_train_step(model, sched):
    """The example's jitted step: ``train_step(state, batch) -> (state,
    {"loss", "grad_norm", "lr"})``, ``lr = sched(state.opt.step)`` on the
    device, the loss through ``model.loss``, then ``apply_gradients``."""
    ndims = leaf_ndims(model)

    def train_step(state: TrainState, batch):
        b = {k: torch.as_tensor(v, device=model.device)
             for k, v in batch.items()}
        lr = sched(state.opt.step)
        with torch.enable_grad():
            loss = model.loss(b)
            params, opt, gnorm = apply_gradients(
                state.params, loss, state.opt, lr=lr, cfg=OPT,
                leaf_ndim=ndims)
        return TrainState(params, opt), {"loss": loss.detach(),
                                         "grad_norm": gnorm, "lr": lr}

    return train_step


def train(model, src, tgt, *, steps: int, batch: int, log_every: int = 25,
          state: TrainState | None = None):
    """``steps`` AdamW steps of ``model.loss`` over the corpus, through the
    compiled step.  Returns ``(state, losses, step_s, target_tokens)``:
    the train state, each step's loss, each step's wall seconds (the host
    reads every loss, so each step ends on the device) and its count of
    target tokens."""
    state = init_train_state(model) if state is None else state
    sched = cosine_schedule(OPT.lr, warmup_steps=WARMUP, total_steps=steps)
    step = compile_train_step(make_nmt_train_step(model, sched), model)
    losses, step_s, tokens = [], [], []
    for it, host in zip(range(steps), batches(src, tgt, batch=batch)):
        t0 = time.perf_counter()
        state, metrics = step(state, host)
        losses.append(metrics["loss"].item())
        step_s.append(time.perf_counter() - t0)
        tokens.append(int(host["tgt_mask"].sum()))
        if log_every and it % log_every == 0:
            print(f"step {it:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
    return state, losses, step_s, tokens


def loss_dropped(losses) -> bool:
    return float(np.mean(losses[-10:])) < float(np.mean(losses[:10]))


def main(argv=None):
    smoke = bool(int(os.environ.get("REPRO_SMOKE", "0")))
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60 if smoke else 200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_nmt_ckpt.npz"))
    ap.add_argument("--model", choices=sorted(MODELS), default="marian")
    ap.add_argument("--pair", choices=sorted(PAPER_MODELS), default="de-en")
    ap.add_argument("--full-width", action="store_true",
                    help="the paper's widths instead of the example's")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = build_model(args.model, full_width=args.full_width,
                        device=device)
    src, tgt = corpus_tokens(args.pair, model.cfg)
    t0 = time.time()
    state, losses, _, _ = train(model, src, tgt, steps=args.steps,
                                batch=args.batch)
    print(f"\nfirst-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean {np.mean(losses[-10:]):.4f} "
          f"({time.time() - t0:.0f}s)")
    params, opt = state_to_jax(model, state.params, state.opt)
    save_checkpoint(args.ckpt, {"params": params, "opt": opt},
                    step=args.steps)
    print(f"checkpoint written to {args.ckpt}")
    if not loss_dropped(losses):
        raise SystemExit("loss did not drop")
    return losses


if __name__ == "__main__":
    main()
