"""The port's analytic cost model against the JAX package's.

``repro_torch.models.costs`` is plain arithmetic over a configuration,
so every function is held EXACTLY equal to ``repro.models.costs`` for all
ten assigned architectures under the four assigned input shapes (each
reference configuration, the long-decode variants and whisper's encoder
included, carried into the port's dataclasses field for field).  Then
the properties of ``tests/test_costs.py`` on the port, with the analytic
forward FLOPs held within 2x of what ``torch.utils.flop_counter`` counts
for the port's own one-layer smoke models (the reference holds them
against XLA's cost analysis the same way).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.models import costs as j_costs
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, qwen3_8b, \
    smoke_config
from repro_torch.configs import get_config
from repro_torch.models import config as mc
from repro_torch.models import costs
from repro_torch.models.model import LM
from _torch_threads import cap_threads

cap_threads()

_NESTED = {"moe": mc.MoEConfig, "mla": mc.MLAConfig, "ssm": mc.SSMConfig,
           "rwkv": mc.RWKVConfig, "encoder": mc.EncoderConfig}


def _port_config(jcfg) -> mc.ModelConfig:
    """The reference configuration in the port's dataclasses."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jcfg)}
    kw["layer_plan"] = tuple(mc.LayerGroup(**dataclasses.asdict(g))
                             for g in jcfg.layer_plan)
    for name, cls in _NESTED.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return mc.ModelConfig(**kw).validate()


def _cells():
    return [(a, s) for a in J_ARCH_NAMES for s in J_INPUT_SHAPES]


def test_the_registry_names_and_shapes_are_the_reference_s():
    assert ARCH_NAMES == J_ARCH_NAMES
    assert INPUT_SHAPES == J_INPUT_SHAPES


@pytest.mark.parametrize("arch,shape", _cells())
def test_every_function_equals_the_reference(arch, shape):
    jcfg = j_get_config(arch, shape=shape)
    cfg = _port_config(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    seq, batch, kind = J_INPUT_SHAPES[shape]
    assert cfg.param_counts() == jcfg.param_counts()
    for kinds in (("train", "prefill", "decode") if kind == "train"
                  else (kind,)):
        mine = costs.step_cost(cfg, kind=kinds, batch=batch, seq=seq)
        ref = j_costs.step_cost(jcfg, kind=kinds, batch=batch, seq=seq)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for tokens, context, decode in ((batch * seq, seq, False),
                                    (batch, seq, True), (1, 1, True)):
        assert costs.forward_flops(cfg, tokens=tokens, context=context,
                                   decode=decode, batch=batch) == \
            j_costs.forward_flops(jcfg, tokens=tokens, context=context,
                                  decode=decode, batch=batch)
    for nbytes in (2, 4):
        assert costs.kv_bytes_per_token(cfg, nbytes) == \
            j_costs.kv_bytes_per_token(jcfg, nbytes)
        assert costs.recurrent_state_bytes(cfg, nbytes) == \
            j_costs.recurrent_state_bytes(jcfg, nbytes)
        a = costs.activation_cost_model(cfg, nbytes)
        b = j_costs.activation_cost_model(jcfg, nbytes)
        assert (a.d_model, a.dtype_bytes, a.per_seq_overhead_bytes) == \
            (b.d_model, b.dtype_bytes, b.per_seq_overhead_bytes)
    for g, jg in zip(cfg.layer_plan, jcfg.layer_plan):
        for t in (1, seq):
            assert costs._ffn_flops(cfg, g, t) == \
                j_costs._ffn_flops(jcfg, jg, t)
            if g.mixer == "mla":
                assert costs._mla_flops(cfg, t, seq, decode=t == 1) == \
                    j_costs._mla_flops(jcfg, t, seq, decode=t == 1)
            elif g.mixer == "mamba2":
                assert costs._mamba_flops(cfg, t) == \
                    j_costs._mamba_flops(jcfg, t)
            elif g.mixer == "rwkv6":
                assert costs._rwkv_flops(cfg, t) == \
                    j_costs._rwkv_flops(jcfg, t)
            else:
                assert costs._attn_flops(cfg, t, seq) == \
                    j_costs._attn_flops(jcfg, t, seq)


@pytest.mark.parametrize("which", ["rnn", "transformer"])
def test_nmt_activation_cost_equals_the_reference(which):
    from repro_torch.models.registry import nmt_config
    pair = "de-en" if which == "rnn" else "en-zh"
    cfg = nmt_config(pair, scale=0.25)
    holder = type("M", (), {"cfg": cfg})()
    for nbytes in (2, 4):
        a = costs.nmt_activation_cost(holder, nbytes)
        b = j_costs.nmt_activation_cost(holder, nbytes)
        assert (a.d_model, a.dtype_bytes) == (b.d_model, b.dtype_bytes)
        np.testing.assert_array_equal(a.payload_bytes([3, 40]),
                                      b.payload_bytes([3, 40]))


# ---------------------------------------- tests/test_costs.py, on the port
def _one_layer(cfg):
    plan = tuple(dataclasses.replace(g, count=1) for g in cfg.layer_plan[:1])
    return dataclasses.replace(cfg, layer_plan=plan, mtp_depth=0)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b"])
def test_forward_flops_match_the_counted_flops(arch):
    """Within 2x both ways of the matmul FLOPs torch counts for the port's
    one-layer smoke model's training forward (torch skips the softmax and
    mask FLOPs; the analytic count halves causal attention)."""
    cfg = _one_layer(smoke_config(arch))
    model = LM(cfg, device="cpu")
    b, s = 2, 64
    toks = torch.zeros((b, s), dtype=torch.int32)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.train_logits(toks)
    counted = counter.get_total_flops()
    ours = costs.forward_flops(cfg, tokens=b * s, context=s, decode=False,
                               batch=b)
    assert 0.5 < ours / counted < 2.0, (ours, counted)


def test_train_step_flops_about_4x_forward():
    cfg = _one_layer(smoke_config("qwen3-8b"))
    sc_t = costs.step_cost(cfg, kind="train", batch=2, seq=64)
    fwd = costs.forward_flops(cfg, tokens=128, context=64, decode=False,
                              batch=2)
    assert 3.5 * fwd < sc_t.flops < 4.5 * fwd + 30 * cfg.param_counts()[
        "total"]


def test_decode_cost_scales_with_context():
    cfg = smoke_config("qwen3-8b")
    c1 = costs.step_cost(cfg, kind="decode", batch=8, seq=1024)
    c2 = costs.step_cost(cfg, kind="decode", batch=8, seq=4096)
    assert c2.hbm_bytes > c1.hbm_bytes
    assert c2.flops > c1.flops
    assert c2.hbm_bytes - c1.hbm_bytes == pytest.approx(
        8 * (4096 - 1024) * costs.kv_bytes_per_token(cfg), rel=0.01)


def test_sliding_window_caps_decode_cost():
    """qwen3-8b's long-decode variant (4096 window) priced at 500k tokens
    of context; the port has no ring cache to run it yet, but the cost
    model prices the configuration."""
    full = get_config("qwen3-8b")
    swa = qwen3_8b.long_decode_variant().validate()
    c_full = costs.step_cost(full, kind="decode", batch=1, seq=524288)
    c_swa = costs.step_cost(swa, kind="decode", batch=1, seq=524288)
    assert c_swa.hbm_bytes < 0.2 * c_full.hbm_bytes


def test_mla_kv_bytes_much_smaller_than_gqa():
    ds = get_config("deepseek-v3-671b")
    q32 = get_config("qwen3-32b")
    mla_per_layer = costs.kv_bytes_per_token(ds) / ds.num_layers
    gqa_per_layer = costs.kv_bytes_per_token(q32) / q32.num_layers
    assert mla_per_layer < 0.4 * gqa_per_layer
    # against a GQA cache of deepseek-v3's own 128 heads of 128: 1/56.9
    gqa = dataclasses.replace(ds, layer_plan=tuple(
        dataclasses.replace(g, mixer="attn") for g in ds.layer_plan),
        mla=None)
    assert costs.kv_bytes_per_token(gqa) / costs.kv_bytes_per_token(ds) == \
        pytest.approx(2 * 128 * 128 / 576)


def test_rwkv_has_no_kv_growth():
    assert costs.kv_bytes_per_token(get_config("rwkv6-3b")) == 0.0
