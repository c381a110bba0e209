"""CUDA graphs of the decode steps, the prefills and the train steps: the
port's form of the reference's ``jax.jit``.

The reference runs a whole greedy decode as ONE ``lax.scan`` under
``jax.jit`` (``batched_greedy_decode``, ``GenerationSession``'s default
path, the slot table's ``_cont_step``): the host dispatches once and the
device runs the compiled steps.  Here a decode step is a function over
STATIC buffers (the decode state, the carried token, the emitted token
columns and a step index kept on the device); it is captured once per
shape into a :class:`torch.cuda.CUDAGraph` and replayed once per token,
so the host submits one graph launch a step instead of every kernel of
it.

* :class:`GraphCache` keeps the graphs of one owner (an NMT model, a
  session, a compiled train step), at most ``max_keys`` keys, least
  recently used first out; evicting a key drops its graphs (an entry's
  ``release()``) and its static buffers.  All graphs of an owner share
  one memory pool (``torch.cuda.graph_pool_handle()``; a cache made with
  ``pool_of=`` another cache, or a function giving one at the first
  capture, shares that one's): they replay one after another
  on one stream, so the temporaries of one may lie where another's were.
  A graph's outputs are therefore read before the next replay of any
  graph of its pool.  Nothing a graph leaves allocated in the pool is
  read by another owner.
* :meth:`GraphCache.capture` runs ``fn()`` once eagerly on the capture
  stream (the warm-up: it builds the kernels' library, allocates
  ``flash_decode``'s split counters and cuBLAS' workspace outside the
  capture), then captures it.  The static buffers that ``fn()`` writes
  are saved before the warm-up and restored after it, so a capture
  leaves them as it found them.  The wrappers' launch counts
  (:func:`repro_torch.kernels.ops.launch_counts`) recorded while
  capturing are taken back, since nothing launched, and added once per
  replay, so the counters count the launches the device really ran.
* :meth:`GraphCache.run_and_capture` is the capture of a step whose
  first call must do real work that nobody can undo cheaply (a prefill
  into a live slot table, a train step over every parameter and both
  moments); nothing is saved or restored.  A cache's first key runs
  ``fn()`` once for real on the capture stream (its warm-up: the
  kernels' library, cuBLAS's workspace and autograd's threads start
  outside any capture), its writes standing, and is then captured;
  ``empty_cache=True`` hands the allocator's cached blocks back between
  the two (a train step's gradients), so that the pool does not sit
  beside them.  Each later key of the cache is captured at once and its
  graph replayed for the real call, so no eager call's temporaries sit
  beside the pool's.
* :func:`eager` is the port's form of ``jax.disable_jit``: while it is
  active every graph-capable path runs its eager loop (the same step
  function, called from Python).  On the CPU the eager loop is the only
  path; a capture raises on a CPU tensor, and a failed capture or replay
  raises: nothing falls back to the eager loop.

The counts live in :mod:`repro_torch.runtime.telemetry`'s counters
(``graphs.captures``, ``graphs.replays``, ``graphs.capture_s`` and
``graphs.keys_built``, each key a cache's ``build()`` made, again after
an eviction); :func:`totals` is their view.  A capture, warm-up
included, is a ``repro_torch.graphs.capture`` span.

:func:`release_all` drops every graph of the process, as a process
group's teardown needs (NCCL waits for the graphs that captured a
communicator's collectives before destroying it).

The capture stream is one per device, shared by every owner:
``flash_decode`` keeps its split counters in a region per stream (64
regions a device), and a graph replays with the region of the stream it
was captured on.  Replays and eager calls of one process run one after
another on the current stream; only that single-threaded use is
supported.
"""

from __future__ import annotations

import collections
import contextlib
import time
import weakref
from typing import Callable, Dict, Hashable, List

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.runtime import telemetry

_EAGER = [0]               # depth of the active eager() contexts
_STREAMS: dict = {}        # device index -> the capture stream
_CACHES = weakref.WeakSet()   # every GraphCache, for release_all()


@contextlib.contextmanager
def eager():
    """While active, every graph-capable decode path runs its eager loop
    (nests; the port's form of ``jax.disable_jit``)."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def is_eager() -> bool:
    return _EAGER[0] > 0


def active(device) -> bool:
    """True when a graph-capable path on ``device`` replays graphs: a
    CUDA device outside :func:`eager`."""
    return torch.device(device).type == "cuda" and not is_eager()


def totals() -> Dict[str, float]:
    """Captures, replays and capture seconds of every cache since the
    last :func:`reset_totals` (telemetry's ``graphs.*`` counters)."""
    return {"captures": int(telemetry.counter("graphs.captures")),
            "replays": int(telemetry.counter("graphs.replays")),
            "capture_s": float(telemetry.counter("graphs.capture_s"))}


def reset_totals() -> None:
    telemetry.zero("graphs.")


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list / tuple, in order (a dict's in
    its insertion order); other leaves are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for child in tree for t in leaves(child)]
    return []


def clone(tree):
    """A copy of a nested dict / list / tuple with every tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone(v) for v in tree)
    return tree


def copy_into(static, fresh) -> None:
    """Copy the tensors of ``fresh`` into those of ``static``, a tree of
    the same structure and shapes."""
    dst, src = leaves(static), leaves(fresh)
    if len(dst) != len(src):
        raise ValueError(f"{len(src)} tensors for {len(dst)} static buffers")
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


def host_tensor(value) -> torch.Tensor:
    """A tensor of ``value`` (a tensor, or a numpy array of any strides)
    to copy into a static buffer."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def signature(tree) -> tuple:
    """The shapes and dtypes of a tree's tensors: a key's shape part."""
    return tuple((tuple(t.shape), t.dtype) for t in leaves(tree))


def _stream(device: torch.device) -> torch.cuda.Stream:
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stream = _STREAMS.get(index)
    if stream is None:
        stream = _STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


class StepGraph:
    """One captured step: ``replay(times)`` runs it on the current stream
    and adds its kernel launches to the wrappers' counters each time.
    ``outputs`` holds what ``fn()`` returned while capturing (tensors in
    the owner's pool that each replay rewrites)."""

    def __init__(self, graph, launches: Dict[str, int], outputs, cache):
        self.graph = graph
        self.launches = launches
        self.outputs = outputs
        self._cache = cache

    def replay(self, times: int = 1) -> None:
        for _ in range(times):
            self.graph.replay()
        if times > 0:
            ops.add_launches(self.launches, times)
            self._cache.replays += times
            telemetry.count("graphs.replays", times)

    def release(self) -> None:
        self.graph.reset()
        self.outputs = None


class GraphCache:
    """The step graphs of one owner, keyed by shape: at most ``max_keys``
    entries, least recently used evicted first.  An entry is whatever its
    ``build()`` returns (a :class:`StepGraph`, or an object holding its graphs
    and static buffers); on eviction its graphs are released.  Counts
    ``captures``, ``replays`` and ``capture_s`` (warm-up included)."""

    def __init__(self, max_keys: int = 4, *, pool_of=None):
        if max_keys < 1:
            raise ValueError("max_keys must be >= 1")
        self.max_keys = max_keys
        self._entries: "collections.OrderedDict[Hashable, object]" = \
            collections.OrderedDict()
        self._pool = None
        self._pool_of = pool_of
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self._building = None        # the key whose build() is running
        _CACHES.add(self)

    def __deepcopy__(self, memo):
        # graphs belong to the device buffers they were captured over: a
        # copied model starts with an empty cache of the same bound
        return GraphCache(self.max_keys)

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> list:
        return list(self._entries)

    def entries(self) -> list:
        return list(self._entries.values())

    def peek(self, key):
        """The entry of ``key`` or None; marks it most recently used."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def get(self, key, build: Callable[[], object]):
        """The entry of ``key``, made by ``build()`` (after evicting down to
        room for it) when absent; marks it most recently used."""
        entry = self.peek(key)
        if entry is not None:
            return entry
        while len(self._entries) >= self.max_keys:
            self._evict()
        telemetry.count("graphs.keys_built")
        outer, self._building = self._building, key
        try:
            entry = build()
        finally:
            self._building = outer
        self._entries[key] = entry
        return entry

    def _evict(self) -> None:
        _, entry = self._entries.popitem(last=False)
        release(entry)

    def clear(self) -> None:
        """Evict every key."""
        while self._entries:
            self._evict()

    def capture(self, fn: Callable[[], object], static=()) -> StepGraph:
        """Warm ``fn()`` up on the capture stream, then capture it.

        ``static`` (a tree of CUDA tensors) is what ``fn()`` writes: saved
        before the warm-up and restored after it.  Raises on a CPU
        tensor, and on any failure of the warm-up or the capture."""
        tensors = leaves(static)
        self._check(tensors)
        with telemetry.span("repro_torch.graphs.capture",
                            kind=key_kind(self._building)):
            t0 = time.perf_counter()
            saved = [t.clone() for t in tensors]
            self._warm_up(fn, tensors)
            for t, s in zip(tensors, saved):
                t.copy_(s)
            del saved
            return self._capture(fn, tensors, t0)

    def run_and_capture(self, fn: Callable[[], object], static=(), *,
                        empty_cache: bool = False):
        """Capture ``fn()`` and make its call real: this cache's first
        capture runs it for real on the capture stream first (its
        warm-up, whose writes stand; ``empty_cache`` then returns the
        allocator's cached blocks to the device), a later one replays
        the graph once after capturing it.  ``static`` (a tree of CUDA
        tensors) is checked as :meth:`capture` checks it.  Returns (the
        graph, what the real call returned: a replay's, the graph's
        outputs)."""
        tensors = leaves(static)
        self._check(tensors)
        with telemetry.span("repro_torch.graphs.capture",
                            kind=key_kind(self._building)):
            t0 = time.perf_counter()
            if self.captures == 0:
                result = self._warm_up(fn, tensors)
                if empty_cache:
                    self._empty_cache()
                return self._capture(fn, tensors, t0), result
            graph = self._capture(fn, tensors, t0)
        graph.replay()
        return graph, graph.outputs

    def _capture(self, fn, tensors, t0: float) -> StepGraph:
        before = ops.launch_counts()
        try:
            graph, outputs = self._record(fn, tensors)
        finally:
            after = ops.launch_counts()
            ops.set_launch_counts(before)            # nothing launched
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        seconds = time.perf_counter() - t0
        self.captures += 1
        self.capture_s += seconds
        telemetry.count("graphs.captures")
        telemetry.count("graphs.capture_s", seconds)
        return StepGraph(graph, launches, outputs, self)

    # the three device-facing steps of a capture
    @staticmethod
    def _check(tensors) -> None:
        for t in tensors:
            if t.device.type != "cuda":
                raise ValueError("CUDA graphs capture CUDA tensors; got one "
                                 f"on {t.device}")

    @staticmethod
    def _device(tensors) -> torch.device:
        return (tensors[0].device if tensors
                else torch.device("cuda", torch.cuda.current_device()))

    def _warm_up(self, fn, tensors):
        device = self._device(tensors)
        stream = _stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            result = fn()
        torch.cuda.current_stream(device).wait_stream(stream)
        return result

    @staticmethod
    def _empty_cache() -> None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def _pool_owner(self) -> "GraphCache":
        """The cache whose pool this one's graphs use: the end of the
        ``pool_of`` chain."""
        owner = self
        while owner._pool_of is not None:
            nxt = owner._pool_of
            owner = nxt() if callable(nxt) else nxt
        return owner

    def _record(self, fn, tensors):
        """Capture ``fn()`` (which runs nothing on the device now) into a
        graph in the owner's pool; returns (graph, what ``fn`` returned)."""
        owner = self._pool_owner()
        if owner._pool is None:
            owner._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph's own context would also empty the allocator's
        # cache at every capture, and the allocator would then map its
        # memory anew: a serving stream meets a new key often
        torch.cuda.synchronize()
        with torch.cuda.stream(_stream(self._device(tensors))):
            graph.capture_begin(pool=owner._pool)
            try:
                outputs = fn()
            finally:
                graph.capture_end()
        return graph, outputs


def key_kind(key) -> str:
    """What a cache key is for: a name, or a tuple's leading name
    (``"translate"``, ``"decode"``, ``"encode"``, ``"generate"``,
    ``"table"``), else its type's (a shape-keyed prefill, wave or train
    step); ``"none"`` outside a ``build()``."""
    if key is None:
        return "none"
    if isinstance(key, str):
        return key
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        return key[0]
    return type(key).__name__


def release(entry) -> None:
    """Drop the graphs of a cache entry: a :class:`StepGraph`, an object
    with a ``release()`` of its own, or one holding step graphs among its
    attributes."""
    if hasattr(entry, "release"):
        entry.release()
        return
    for value in getattr(entry, "__dict__", {}).values():
        if isinstance(value, StepGraph):
            value.release()


def release_all() -> None:
    """Drop every graph of every cache (a later call captures anew).
    Destroying an NCCL communicator waits until every graph that captured
    one of its collectives is gone: call this before
    ``destroy_process_group`` on the groups of a sharded model that
    replayed graphs."""
    for cache in list(_CACHES):
        cache.clear()


def owner_cache(owner, max_keys: int) -> GraphCache:
    """``owner``'s :class:`GraphCache` (made at the first call).  An
    owner with a ``graph_pool_owner`` (a sharded LM: its LM) shares that
    one's pool, so a model's sharded and unsharded sessions keep one."""
    cache = getattr(owner, "_step_graphs", None)
    if cache is None:
        base = getattr(owner, "graph_pool_owner", None)
        cache = GraphCache(max_keys, pool_of=None if base is None else (
            lambda: owner_cache(base, max_keys)))
        owner._step_graphs = cache
    return cache
