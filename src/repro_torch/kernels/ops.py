"""Public kernel wrappers: the CUDA kernels on the card, their plain
versions on the CPU.

Port of ``repro/kernels/ops.py``, with the same argument layouts.  The
device of the query tensor decides: a CPU tensor takes the kernel's
plain PyTorch version; any other tensor goes to the kernel's wrapper,
which launches on a CUDA tensor or raises.  Nothing falls back.

Each wrapper counts its kernel launches in a plain integer attribute
(``flash_attention.launches``, ``rwkv6_wkv.launches``, ...), so a run
can show that its main path went through the kernels.  A wrapper called
while a CUDA graph is being captured launches nothing then: the graph
(``repro_torch.runtime.graphs``) takes those counts back and adds them
again at every replay (:func:`add_launches`), so the counters count the
launches the device ran.

The kernels are forward-only, as their Pallas originals are (none has a
VJP), and their outputs come from ``torch.empty`` through ``ctypes``, so
autograd would not see them: a backward through one would silently drop
the gradient of everything in front of it.  So each wrapper raises
before it launches while grad mode is on and a tensor argument requires
grad.  Training takes the differentiable paths the reference's training
takes (``MarianTransformer.forward_teacher(kernels=False)``, which
``loss`` uses, and ``LM.train_logits``); evaluation calls the kernel
paths under ``torch.no_grad()``.  On the CPU nothing changes: the plain
versions there are differentiable.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rwkv6_wkv as _wkv
from repro_torch.kernels import ssd_scan as _ssd


_TRAINING_PATHS = {
    "flash_attention": "MarianTransformer.loss, which runs forward_teacher("
                       "kernels=False), or LM.train_logits",
    "flash_decode": "the cached decode step is inference only; "
                    "MarianTransformer.loss trains the decoder by teacher "
                    "forcing",
    "rwkv6_wkv": "LM.train_logits",
    "ssd_scan": "LM.train_logits",
}


def _refuse_autograd(name: str, *tensors) -> None:
    """Raise if launching kernel ``name`` on these operands would need a
    backward it does not have."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is a forward-only CUDA kernel, as its Pallas original "
            "is: autograd cannot differentiate it and would silently drop "
            "the gradient of every operand.  Train through the "
            f"differentiable path ({_TRAINING_PATHS[name]}), or call this "
            "under torch.no_grad().")


def flash_attention(q, k, v, lengths=None, *, causal: bool = True,
                    scale: float | None = None, window: int | None = None):
    """q (B,S,H,D); k/v (B,T,Hkv,D); lengths (B,) or None -> (B,S,H,D).
    ``window`` (causal only) masks keys at or below q_pos - window."""
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, lengths, causal=causal,
                                         scale=scale, window=window)
    _refuse_autograd("flash_attention", q, k, v)
    out = _fa.flash_attention_cuda(q, k, v, lengths, causal=causal,
                                   scale=scale, window=window)
    flash_attention.launches += 1
    return out


def flash_decode(q, k_cache, v_cache, lengths, *, scale=None,
                 window: int | None = None, return_stats: bool = False):
    """q (B,H,D); caches (B,S,Hkv,D); lengths (B,) -> (B,H,D).
    ``window`` masks the slots below lengths - window; ``return_stats``
    also returns each row's softmax max and normaliser (B,H) float32."""
    if q.device.type == "cpu":
        return _da.flash_decode_plain(q, k_cache, v_cache, lengths,
                                      scale=scale, window=window,
                                      return_stats=return_stats)
    _refuse_autograd("flash_decode", q, k_cache, v_cache)
    out = _da.flash_decode_cuda(q, k_cache, v_cache, lengths, scale=scale,
                                window=window, return_stats=return_stats)
    flash_decode.launches += 1
    return out


def rwkv6_wkv(r, k, v, log_w, u, s0=None, *, chunk: int = 32):
    """Chunked WKV6.  r/k/v/log_w (B,S,H,P), u (H,P), s0 (B,H,P,P) or None
    -> (y (B,S,H,P), s_final (B,H,P,P) float32)."""
    if r.device.type == "cpu":
        return _wkv.rwkv6_wkv_plain(r, k, v, log_w, u, s0, chunk=chunk)
    _refuse_autograd("rwkv6_wkv", r, k, v, log_w, u, s0)
    out = _wkv.rwkv6_wkv_cuda(r, k, v, log_w, u, s0, chunk=chunk)
    rwkv6_wkv.launches += 1
    return out


def ssd_scan(x, dt, a_log, b_in, c_in, s0=None, *, chunk: int = 64):
    """Chunked Mamba2 SSD.  x (B,S,H,P), dt (B,S,H), a_log (H,), b/c
    (B,S,H,N), s0 (B,H,P,N) or None -> (y (B,S,H,P), s_final (B,H,P,N)
    float32)."""
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt, a_log, b_in, c_in, s0, chunk=chunk)
    _refuse_autograd("ssd_scan", x, dt, a_log, b_in, c_in, s0)
    out = _ssd.ssd_scan_cuda(x, dt, a_log, b_in, c_in, s0, chunk=chunk)
    ssd_scan.launches += 1
    return out


_WRAPPERS = {"flash_attention": flash_attention,
             "flash_decode": flash_decode,
             "rwkv6_wkv": rwkv6_wkv,
             "ssd_scan": ssd_scan}
for _fn in _WRAPPERS.values():
    _fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set the counters to ``counts`` (a :func:`launch_counts` result)."""
    for name, n in counts.items():
        _WRAPPERS[name].launches = n


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` launches (a replayed graph's)."""
    for name, n in counts.items():
        _WRAPPERS[name].launches += n * times
