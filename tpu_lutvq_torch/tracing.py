"""The port's own tracing: named host ranges and the batchers' tick account.

- :func:`span`: a range ``lutvq.<layer>[.<part>]`` recorded while a
  ``torch.profiler`` runs (``utils.profiling.trace`` or any other); with
  none running a site costs a flag check and a shared no-op context.
- :data:`TICKS`: every ``ContinuousBatcher``'s account of its ticks, always
  kept: a few ``time.perf_counter`` stamps and host integers a tick.

This module imports nothing of the package, so every module of it, the
kernel wrappers included, can use it.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import NamedTuple

import torch

# -- spans -----------------------------------------------------------------------

_enabled = torch.autograd._profiler_enabled
# the profiler's C++ range where this torch has it: a sixth of
# ``record_function``'s cost a span on the H100's host (1.7 against 10.4 µs),
# the same range, listed as a ``cpu_op`` rather than a ``user_annotation``
_RECORD = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function


class _Null:
    """The shared no-op context a span site gets with no profiler running.
    Its ``__enter__`` and ``__exit__`` are one C builtin that takes any
    arguments and returns ``""``: falsy, so an exception passes through, and
    entering the context runs no Python frame (a site costs 180 ns on the
    H100's host, 466 ns with Python methods)."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_NULL = _Null()


def span(name: str):
    """``with span("lutvq.admit"): ...``: a profiler range named ``name``
    while a profiler runs, else the shared no-op context.  ``name`` is a
    fixed string (no index or id): traces are reduced by name."""
    return _RECORD(name) if _enabled() else _NULL


# -- the tick account ------------------------------------------------------------


class Admission(NamedTuple):
    """One admission group of a tick: a wave (one prefill of its prompts
    padded to a shared power-of-two bucket), a single prefill or a chunked
    one.  ``rows``: the prefill rows computed, prompts × bucket for a wave
    and the prompt's length otherwise."""

    prompt_lens: list
    rows: int


@dataclasses.dataclass
class TickRecord:
    """A batcher's account of one tick (one dispatch and its collect), on
    ``time.perf_counter``: host numbers only, never device tensors (a
    replay's device seconds are read at collect, once its tokens are)."""

    batcher: int  # the batcher's ``batcher_id``
    t_start: float  # dispatch begins
    t_admitted: float = float("nan")  # admission's launches returned
    t_dispatched: float = float("nan")  # the decode roll's last launch returned
    t_end: float = float("nan")  # the readback and the tick's bookkeeping done
    admissions: list = dataclasses.field(default_factory=list)  # Admission, in order
    steps: int = 0  # decode steps of the roll
    replayed: int = 0  # of those, the steps a CUDA graph replay served
    replay_s: float = float("nan")  # that replay's device seconds (CUDA events around it)


# every batcher's records, oldest first, appended as each tick is collected
TICKS: collections.deque = collections.deque(maxlen=4096)
BATCHER_IDS = itertools.count()
