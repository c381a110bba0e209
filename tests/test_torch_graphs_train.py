"""The port's compiled train step on the CPU.

On the card ``compile_train_step`` (the port's ``jax.jit`` of a train
step) replays one CUDA graph per batch key; a key's first call is a real
step, run before the capture, and the step counter rides in the state's
``opt.step`` tensor from replay to replay.  Here the graphs are stubbed
(``tests/test_torch_graphs.py``'s ``StubCache``: a replay runs the step
again and writes its outputs where the capture's were), so the
bookkeeping around them runs as on the card.

* ``make_train_step`` through the wrapper, 3 steps on the smoke qwen3-8b
  (attention) and rwkv6-3b under a cosine schedule: every loss, grad
  norm and ``lr``, and every parameter and moment after 3 steps, equal
  ``graphs.eager()``'s bitwise, and the losses the JAX reference's
  jitted ``make_train_step`` on the same weights and batch;
* ``launch/train_nmt.train`` on the example's small Marian and GRU, whose
  batches change shape from step to step: bitwise equal to eager, and
  the losses within 1e-4 of the example's jitted step's;
* the step counter and the cosine ``lr`` computed from it, metrics that
  later replays do not overwrite, keys evicted least recently used, a
  counter passed in from outside, a model that is not ``graph_safe``
  (the LM inside a sharded one) stepping eagerly, and CPU trainers never
  capturing.  A sharded LM's compiled step: ``test_torch_graphs_sharded.py``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nmt import GRUSeq2Seq as JGRU
from repro.nmt import MarianTransformer as JMarian
from repro.nmt import RNNConfig as JRNNConfig
from repro.nmt import TransformerConfig as JTConfig
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_init as j_adamw_init
from repro.training.optimizer import adamw_update as j_adamw_update
from repro.training.optimizer import clip_by_global_norm as j_clip
from repro.training.optimizer import cosine_schedule as j_cosine
from repro.training.train_loop import TrainState as JTrainState
from repro.training.train_loop import make_train_step as j_make_train_step
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as train_cli
from repro_torch.launch import train_nmt
from repro_torch.runtime import graphs
from repro_torch.training import train_loop
from repro_torch.training.optimizer import cosine_schedule
from repro_torch.training.train_loop import (
    TrainState,
    compile_train_step,
    init_train_state,
    make_train_step,
)
from _torch_threads import cap_threads
from test_torch_graphs import stub_graphs  # noqa: F401
from test_torch_training import jax_lm, lm_batch, port_lm

cap_threads()

STEPS = 3


def _state_tensors(state):
    return ([p.detach() for p in state.params.values()]
            + list(state.opt.mu.values()) + list(state.opt.nu.values())
            + [state.opt.step])


def _assert_states_equal(got, want):
    a, b = _state_tensors(got), _state_tensors(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _lm_run(arch, batches):
    model = port_lm(arch)
    sched = cosine_schedule(1e-3, warmup_steps=1, total_steps=STEPS)
    step = compile_train_step(make_train_step(model, lr_schedule=sched),
                              model)
    state, metrics = init_train_state(model), []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append(m)
    return state, metrics, step


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-3b"])
def test_lm_train_step_graph_equals_eager_and_jax(stub_graphs, arch):
    batch = lm_batch(arch, seed=4)
    with graphs.eager():
        want, want_m, _ = _lm_run(arch, [batch] * STEPS)
    got, got_m, step = _lm_run(arch, [batch] * STEPS)
    _assert_states_equal(got, want)
    snapshot = [{k: float(v) for k, v in m.items()} for m in got_m]
    for g, w in zip(got_m, want_m):
        assert set(g) == set(w)
        for k in g:
            assert torch.equal(g[k], w[k]), k
    # one batch shape: one key, captured at the first step, then replayed
    assert step.graphs.captures == 1 and step.graphs.replays == STEPS - 1
    assert int(got.opt.step) == STEPS
    sched = cosine_schedule(1e-3, warmup_steps=1, total_steps=STEPS)
    for i, m in enumerate(got_m):
        assert torch.equal(m["lr"], sched(torch.tensor(i, dtype=torch.int32)))
    # the metrics are copies: later replays left the earlier ones as read
    assert snapshot == [{k: float(v) for k, v in m.items()} for m in got_m]

    jm, params = jax_lm(arch)
    j_step = jax.jit(j_make_train_step(jm, lr_schedule=j_cosine(
        1e-3, warmup_steps=1, total_steps=STEPS)))
    jstate = JTrainState(params, j_adamw_init(params))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for m in got_m:
        jstate, jm_ = j_step(jstate, jb)
        assert float(m["loss"]) == pytest.approx(float(jm_["loss"]),
                                                 rel=1e-4)
        # rwkv6's gradient is ill-conditioned on the smoke plan (see
        # test_torch_training's train-step test): 1e-3
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=1e-3)
        assert float(m["lr"]) == pytest.approx(float(jm_["lr"]), rel=1e-6)


def test_train_keys_counter_and_lru(stub_graphs, monkeypatch):
    monkeypatch.setattr(train_loop, "TRAIN_GRAPH_KEYS", 2)
    arch = "qwen3-8b"
    shapes = [lm_batch(arch, seed=1), lm_batch(arch, seed=2, s=8),
              lm_batch(arch, seed=3, b=1)]
    batches = [shapes[i] for i in (0, 1, 2, 0, 1)]
    with graphs.eager():
        want, want_m, _ = _lm_run(arch, batches)
    got, got_m, step = _lm_run(arch, batches)
    _assert_states_equal(got, want)
    for g, w in zip(got_m, want_m):
        assert all(torch.equal(g[k], w[k]) for k in g)
    # (2,16), (2,8), (1,16) through two keys: every call a new capture
    assert step.graphs.captures == 5 and len(step.graphs) == 2
    assert int(got.opt.step) == len(batches)

    # one counter for every graph of a state; another passed in is read
    model = port_lm(arch)
    step = compile_train_step(make_train_step(model), model)
    state, _ = step(init_train_state(model), shapes[0])
    counter = state.opt.step
    state, _ = step(state, shapes[1])
    assert state.opt.step is counter and int(counter) == 2
    outside = TrainState(state.params, state.opt._replace(
        step=torch.tensor(10, dtype=torch.int32)))
    state, _ = step(outside, shapes[0])
    assert state.opt.step is counter and int(counter) == 11


def _nmt_models(family):
    cfg = train_nmt.SMALL[family]
    jcls, jcfg = ((JMarian, JTConfig) if family == "marian"
                  else (JGRU, JRNNConfig))
    jm = jcls(jcfg(**dataclasses.asdict(cfg)))
    params = jm.init(jax.random.PRNGKey(0))

    def port():
        model = train_nmt.build_model(family, device="cpu")
        model.load_state_dict(params_from_jax(
            model, jax.tree.map(np.asarray, params)), strict=True)
        return model

    return jm, params, port


@pytest.mark.parametrize("family", ["marian", "gru"])
def test_train_nmt_graph_equals_eager_and_jax(stub_graphs, family):
    steps, batch = 3, 8
    jm, params, port = _nmt_models(family)
    model = port()
    src, tgt = train_nmt.corpus_tokens("de-en", model.cfg, size=256)
    with graphs.eager():
        want, want_losses, _, _ = train_nmt.train(
            port(), src, tgt, steps=steps, batch=batch, log_every=0)
    got, losses, _, _ = train_nmt.train(model, src, tgt, steps=steps,
                                        batch=batch, log_every=0)
    assert losses == want_losses
    _assert_states_equal(got, want)
    shapes = {tuple(b["src"].shape + b["tgt_in"].shape) for b, _ in zip(
        train_nmt.batches(src, tgt, batch=batch), range(steps))}
    assert len(shapes) > 1              # the batches change shape

    # the example's loop: lr = sched(opt.step), then its jitted step
    cfg = JAdamWConfig(lr=3e-4, weight_decay=0.01)
    sched = j_cosine(3e-4, warmup_steps=train_nmt.WARMUP, total_steps=steps)

    @jax.jit
    def j_step(params, opt, batch, lr):
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        grads, _ = j_clip(grads, cfg.clip_norm)
        params, opt = j_adamw_update(params, grads, opt, lr=lr, cfg=cfg)
        return params, opt, loss

    opt = j_adamw_init(params)
    for host, want_loss in zip(train_nmt.batches(src, tgt, batch=batch),
                               losses[:2]):         # a compile a shape
        jb = {k: jnp.asarray(v) for k, v in host.items()}
        params, opt, loss = j_step(params, opt, jb, sched(opt.step))
        assert want_loss == pytest.approx(float(loss), rel=1e-4)


def test_graph_unsafe_models_step_eagerly(stub_graphs):
    calls = []

    def train_step(state, batch):
        calls.append(batch)
        return state, {}

    sharded = types.SimpleNamespace(device=torch.device("cpu"),
                                    graph_safe=False)
    step = compile_train_step(train_step, sharded)
    for _ in range(2):
        step(None, {"tokens": np.zeros((1, 2), np.int32)})
    assert len(calls) == 2 and step.graphs.captures == 0


def test_cpu_trainers_never_capture(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a CPU path captured a graph")

    monkeypatch.setattr(graphs.GraphCache, "capture", refuse)
    monkeypatch.setattr(graphs.GraphCache, "run_and_capture", refuse)
    losses = train_cli.main(["--arch", "qwen3-8b", "--smoke", "--device",
                             "cpu", "--steps", "2", "--batch", "2",
                             "--seq", "8"])
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    model = train_nmt.build_model("gru", device="cpu")
    src, tgt = train_nmt.corpus_tokens("de-en", model.cfg, size=64)
    _, losses, _, _ = train_nmt.train(model, src, tgt, steps=2, batch=4,
                                      log_every=0)
    assert len(losses) == 2 and np.all(np.isfinite(losses))
