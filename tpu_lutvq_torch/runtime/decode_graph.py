"""The batcher's decode roll as CUDA graphs, one per (window, horizon).

The reference runs a tick's roll as one jitted ``lax.scan``
(``tpu_lutvq/runtime/batching.py:461-489``) whose ``jit`` keys on
``horizon`` and ``window`` alone: every roll decodes all ``n_slots`` rows
(inactive slots at position 0), so nothing else about its shapes changes
between ticks.  :class:`DecodeGraphs` keeps the port's roll on the same
key.  The first tick that meets a key runs the eager roll, which also makes
every device tensor the roll builds lazily (divisors, tables, plans); the
next tick with the key captures the roll reading the holder's static
inputs, and every tick with the key copies its inputs in and replays.  A
replay runs the eager roll's kernels in the same order on the same buffers,
so its tokens and cache bytes are the eager roll's.

- The caches are written in place; a capture checks that the roll left
  ``batcher.caches`` on the same storage.  The paged pool's block tables
  are written in place between ticks, so a replay reads the current rows.
- The batcher's sampling generator is registered with every graph: a
  replay draws from the generator's state at that moment and advances it
  as the eager roll would.
- The roll's ``(horizon, B)`` output is copied out of the static buffer at
  each replay, so a tick's tokens survive the next replay.
- Each replay is timed on the card (two CUDA events around the launch, no
  node of the graph), so its kernels' device time stays readable though
  no host call of the roll runs.
- The kernel launch counters (``*_LAUNCHES``) count launches served: a
  capture launches nothing and takes its counts back, and each replay adds
  them.
- A key first met while a profiler runs stays eager until it stops: a
  capture synchronises the card and repeats the roll's host work.
"""

from __future__ import annotations

import importlib
from typing import Callable

import torch

_KERNEL_MODULES = ("lut_gemv", "dequant_mm", "flash_decode", "flash_prefill")


def launch_counters() -> list:
    """(module, name) of every kernel launch counter (``*_LAUNCHES``)."""
    mods = [importlib.import_module(f"tpu_lutvq_torch.kernels.{m}") for m in _KERNEL_MODULES]
    return [(m, n) for m in mods for n in sorted(vars(m)) if n.endswith("_LAUNCHES")]


def leaves(tree) -> list:
    """The tensors of a cache container (one cache, or a tuple of them), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree if x is not None for t in leaves(x)]


def _storage(caches) -> list:
    return [t.data_ptr() for t in leaves(caches)]


def same_cache_bytes(a, b) -> bool:
    """Two batchers' caches hold the same bytes wherever a sequence can read:
    a paged pool's junk block 0 (pad rows and free slots write there, in no
    fixed order between duplicate rows) left out."""
    from tpu_lutvq_torch.models.kv_cache import KVCache
    from tpu_lutvq_torch.models.paged_cache import PagedKVCache

    pairs = [(a, b)] if isinstance(a, KVCache) else list(zip(a, b))
    for x, y in pairs:
        for name, u in x._asdict().items():
            v = getattr(y, name)
            if isinstance(x, PagedKVCache) and name != "block_tables":
                u, v = u[1:], v[1:]
            if not torch.equal(u, v):
                return False
    return True


class CudaGraphs:
    """Graphs on the card that share one memory pool and one capture
    stream, each with the batcher's sampling generator registered."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream()

    def capture(self, fn: Callable[[], torch.Tensor]):
        """Capture ``fn``'s launches: (replay, the static output).  ``replay()``
        launches the graph and returns a callable that gives the replay's
        device seconds once its work has run."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        torch.cuda.synchronize()
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                out = fn()
            finally:
                graph.capture_end()

        def replay():
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph.replay()
            end.record()

            def seconds() -> float:
                end.synchronize()
                return start.elapsed_time(end) / 1e3

            return seconds

        return replay, out


class DecodeGraphs:
    """A batcher's decode rolls by (window, horizon): eager at a key's
    first tick, then captured once and replayed.  ``backend`` makes the
    graphs (by default :class:`CudaGraphs` on ``generator``, the batcher's
    sampling generator, made at the first capture).  The holder keeps no
    reference to its batcher: each call is given the eager roll and the
    batcher's caches."""

    def __init__(self, generator: torch.Generator, backend=None):
        self.generator = generator
        self.backend = backend
        self.graphs: dict = {}  # (window, horizon) → (replay, static output, counter deltas)
        self.seen: set = set()  # keys whose eager tick has run
        self.static = None  # the static (tokens, positions, temperatures)

    def roll(self, run: Callable, caches: Callable, tok_vec, pos_dev, temps_dev,
             horizon: int, window: int):
        """The roll's ``(horizon, B)`` tokens, and for a replay a callable
        giving its device seconds once the tokens are read (None where the
        eager roll served them).  ``run(tok_vec, pos_dev, temps_dev,
        horizon, window)`` is the eager roll; ``caches()`` gives the
        caches it writes."""
        key = (window, horizon)
        entry = self.graphs.get(key)
        if entry is None:
            if key not in self.seen or torch.autograd._profiler_enabled():
                self.seen.add(key)
                return run(tok_vec, pos_dev, temps_dev, horizon, window), None
            if self.static is None:
                self.static = tuple(torch.empty_like(t) for t in (tok_vec, pos_dev, temps_dev))
        for buf, src in zip(self.static, (tok_vec, pos_dev, temps_dev)):
            buf.copy_(src)
        if entry is None:
            entry = self.graphs[key] = self._capture(run, caches, horizon, window)
        replay, out, deltas = entry
        seconds = replay()
        for (mod, name), d in deltas:
            setattr(mod, name, getattr(mod, name) + d)
        return out.clone(), seconds

    def _capture(self, run: Callable, caches: Callable, horizon: int, window: int):
        if self.backend is None:
            self.backend = CudaGraphs(self.generator)
        counters = launch_counters()
        before = [getattr(m, n) for m, n in counters]
        storage = _storage(caches())
        static = self.static
        replay, out = self.backend.capture(lambda: run(*static, horizon, window))
        if _storage(caches()) != storage:
            raise RuntimeError("the captured decode roll moved the batcher's caches")
        deltas = []
        for (mod, name), n in zip(counters, before):
            deltas.append(((mod, name), getattr(mod, name) - n))
            setattr(mod, name, n)  # a capture launches nothing
        return replay, out, [d for d in deltas if d[1]]
