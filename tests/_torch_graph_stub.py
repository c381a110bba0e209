"""Stubbed CUDA graphs for the port's CPU tests: the graph paths of
``repro_torch.runtime.graphs`` run on the CPU, with a guard against what
no capture on the card allows.

:class:`StubCache` stands in for ``GraphCache``: no CUDA check, the
warm-up a plain call, the capture a call whose writes are undone (a
capture runs nothing), and a "replay" (:class:`_StubGraph`) that runs
the captured step again and writes its outputs into the tensors the
capture returned, as a graph rewrites the same memory.  While a stubbed
capture runs, every host transfer that would break a capture on the card
raises :class:`HostTransferInCapture`: ``Tensor.tolist``, ``.item``,
``.cpu``, ``.numpy``, ``.new_tensor``, ``bool()`` of a tensor, and
``torch.as_tensor`` /
``torch.tensor`` of a host list or array, or of a number sent to a
device (a number with no device stays a host scalar).

:func:`install` patches ``graphs`` for a whole process (the multi-rank
workers, which import neither pytest nor JAX); the tests' fixtures
patch the same two names through ``monkeypatch``.
"""

import contextlib

import torch

from repro_torch.kernels import ops
from repro_torch.runtime import graphs


class HostTransferInCapture(RuntimeError):
    """A host transfer ran inside a (stubbed) graph capture."""


def _refuse(what):
    def call(*args, **kwargs):
        raise HostTransferInCapture(f"{what} inside a graph capture")
    return call


@contextlib.contextmanager
def host_transfers_refused():
    """While active, the host transfers a capture cannot hold raise."""
    saved = {name: getattr(torch.Tensor, name)
             for name in ("tolist", "item", "cpu", "numpy", "__bool__",
                          "new_tensor")}
    as_tensor, tensor = torch.as_tensor, torch.tensor

    def no_upload(make):
        # host data sent to a device; a number kept as a host scalar
        # (no device given) is an argument, not a transfer
        def call(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor) and (
                    "device" in kwargs or not isinstance(
                        data, (bool, int, float))):
                raise HostTransferInCapture(
                    f"torch.{make.__name__} of a {type(data).__name__} "
                    "inside a graph capture")
            return make(data, *args, **kwargs)
        return call

    for name in saved:
        setattr(torch.Tensor, name, _refuse(f"Tensor.{name}"))
    torch.as_tensor, torch.tensor = no_upload(as_tensor), no_upload(tensor)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        torch.as_tensor, torch.tensor = as_tensor, tensor


class _StubGraph:
    """A CUDA graph's stand-in: ``replay`` runs the captured step again and
    writes what it returns into the captured outputs; the wrappers' counts
    stay as they were (a replay calls no wrapper)."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def replay(self):
        before = ops.launch_counts()
        graphs.copy_into(self.outputs, self.fn())
        ops.set_launch_counts(before)

    def reset(self):
        self.fn = None


class StubCache(graphs.GraphCache):
    """``GraphCache`` with the device steps stubbed: no CUDA check, the
    warm-up a plain call, the capture a call whose writes are undone (a
    capture runs nothing) and which refuses host transfers."""

    @staticmethod
    def _check(tensors):
        pass

    def _warm_up(self, fn, tensors):
        return fn()

    @staticmethod
    def _empty_cache():
        pass

    def _record(self, fn, tensors):
        saved = [t.clone() for t in tensors]
        with host_transfers_refused():
            outputs = fn()
        with torch.no_grad():                 # a train step's parameters
            for t, s in zip(tensors, saved):
                t.copy_(s)
        return _StubGraph(fn, outputs), outputs


def stub_active(device) -> bool:
    """``graphs.active`` with the stub: every device, outside ``eager()``."""
    return not graphs.is_eager()


def install() -> None:
    """Stub the graphs for the rest of this process."""
    graphs.GraphCache = StubCache
    graphs.active = stub_active
    graphs.reset_totals()
