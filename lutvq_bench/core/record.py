"""What a run records, on the host's clock, for the readers."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Tick:
    """One ``step()`` of the batcher.  ``admitted``, ``positions`` and
    ``steps`` are the batcher's own account of the tick (its ticket), None
    where the run could not read it."""

    index: int
    start: float
    end: float
    admitted: Optional[list]  # prompt lengths the tick admitted, in admission order
    positions: Optional[list]  # each decoded slot's position at the tick's first step
    steps: Optional[int]  # decode steps the tick ran
    tokens: int  # tokens the host received at its end
    n_slots: int
    traced: bool = False  # run inside the profiled slice


@dataclasses.dataclass
class Served:
    """One request, as its client sees it."""

    req_id: int
    client: int
    prompt_len: int
    max_new: int
    submit_t: float
    receipts: list = dataclasses.field(default_factory=list)  # (time, tokens)
    done_t: Optional[float] = None

    @property
    def first_t(self) -> Optional[float]:
        return self.receipts[0][0] if self.receipts else None

    @property
    def n_out(self) -> int:
        return sum(n for _, n in self.receipts)


@dataclasses.dataclass
class RunRecord:
    """A run's window and everything the readers take their numbers from."""

    model: dict  # the architecture's numbers (models/<arch>.py ``arch``)
    mix: dict
    t_start: float  # process start
    window_open: float = 0.0
    window_end: float = 0.0
    ticks: list = dataclasses.field(default_factory=list)
    served: list = dataclasses.field(default_factory=list)
    slice_span: Optional[tuple] = None  # host interval the profiler disturbed
    trace: Optional[object] = None  # core.tracing.Summary of a traced run
    spans: Optional[dict] = None  # span name → what its call was given
    setup: dict = dataclasses.field(default_factory=dict)  # set-up phases, seconds
    batcher_seen: bool = True  # the ticks carry the batcher's account of each tick

    def window_ticks(self, untraced: bool = False) -> list:
        return [t for t in self.ticks if t.start >= self.window_open and t.end <= self.window_end
                and not (untraced and t.traced)]

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.window_open < t <= self.window_end
