"""The traced run: spans around the calls into each layer, a profiled slice
of the window, and the reduction of its trace.

Spans come from the benchmark's own wrappers, placed by reference around
the program's layer entry points for the slice only (``TARGETS``); a
target the program no longer has is left out, and what would read it
reads nothing.  Each span is a ``torch.profiler.record_function`` range
named ``lb/<kind>#<n>``; what its call was given (shapes, item sizes, the
tick and decode step it ran in) is kept beside it on the host.

The reduction reads the profiler's Chrome trace: each device activity
(kernel, copy, fill) is tied to the host call that launched it (the CUDA
runtime call of the same correlation id, else the host op of its external
id), and so to the spans open at that moment on the main thread.  A span
whose launches did not all come back as device activity is incomplete, and
readers that divide by device time leave it out.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
import time

# (module, attribute path, span kind): the program's layer entry points
TARGETS = (
    ("tpu_lutvq_torch.runtime.batching", "llama_forward", "prefill"),
    ("tpu_lutvq_torch.runtime.generate", "llama_forward", "prefill"),  # chunked prefill
    ("tpu_lutvq_torch.runtime.batching", "llama_decode_step", "decode"),
    ("tpu_lutvq_torch.models.linear", "QuantizedLinear.apply", "proj"),
    ("tpu_lutvq_torch.models.llama", "_attention", "attn"),
)
KINDS = ("tick", "prefill", "decode", "proj", "attn")
_SPAN = re.compile(r"^lb/(\w+)#(\d+)$")


def _nbytes(t) -> int:
    return t.element_size() if hasattr(t, "element_size") else 0


class Tracer:
    """Wrappers, spans and the profiler of one slice of the window."""

    def __init__(self, device):
        self.device = device
        self.spans: dict = {}  # "kind#n" → what the call was given
        self.started = False
        self.active = False
        self.t_begin = self.t_end = None
        self.missing: list = []
        self._tick = None
        self._phase = None  # ("prefill", n) or ("decode", step) while inside one
        self._step = 0
        self._installed = []
        self._prof = None
        self._slice = None

    # -- spans --

    def _span(self, kind: str, meta: dict):
        import torch

        name = f"{kind}#{len(self.spans)}"
        meta.update(kind=kind, tick=self._tick)
        self.spans[name] = meta
        return name, torch.profiler.record_function("lb/" + name)

    def tick(self, index: int):
        self._tick, self._step = index, 0
        return self._span("tick", {})[1]

    def _wrap(self, kind: str, orig):
        tracer = self

        if kind == "prefill":
            def wrapped(*args, **kw):
                # (cfg, weights, tokens (B, T), caches, pos, ...): a position
                # given as a tensor is not read (that would wait on the card)
                tokens, pos = args[2], args[4] if len(args) > 4 else kw.get("pos")
                name, rf = tracer._span(kind, {"rows": tokens.shape[0], "t": tokens.shape[1],
                                               "offset": pos if isinstance(pos, int) else None})
                prev, tracer._phase = tracer._phase, ("prefill", name)
                try:
                    with rf:
                        return orig(*args, **kw)
                finally:
                    tracer._phase = prev
        elif kind == "decode":
            def wrapped(*args, **kw):
                step = tracer._step
                tracer._step += 1
                name, rf = tracer._span(kind, {"rows": args[2].shape[0], "step": step})
                prev, tracer._phase = tracer._phase, ("decode", step)
                try:
                    with rf:
                        return orig(*args, **kw)
                finally:
                    tracer._phase = prev
        elif kind == "proj":
            def wrapped(self_, cfg, x, *args, **kw):
                meta = {"rows": x.numel() // x.shape[-1], "d_in": x.shape[-1], "x_bytes": _nbytes(x)}
                _, rf = tracer._span(kind, meta)
                with rf:
                    y = orig(self_, cfg, x, *args, **kw)
                meta.update(d_out=y.shape[-1], y_bytes=_nbytes(y))
                return y
        else:  # attn: (cfg, q (B, T, H, Dh), cache, t_offset, window, attn, plain)
            def wrapped(cfg, q, *args, **kw):
                meta = {"q_shape": tuple(q.shape), "q_bytes": _nbytes(q), "phase": tracer._phase}
                _, rf = tracer._span(kind, meta)
                with rf:
                    out = orig(cfg, q, *args, **kw)
                meta["out_bytes"] = _nbytes(out)
                return out
        return wrapped

    def _install(self) -> None:
        import importlib

        for module, path, kind in TARGETS:
            try:
                owner = importlib.import_module(module)
                *outer, attr = path.split(".")
                for part in outer:
                    owner = getattr(owner, part)
                orig = getattr(owner, attr)
            except (ImportError, AttributeError):
                self.missing.append(f"{module}.{path}")
                continue
            setattr(owner, attr, self._wrap(kind, orig))
            self._installed.append((owner, attr, orig))

    def _uninstall(self) -> None:
        for owner, attr, orig in reversed(self._installed):
            setattr(owner, attr, orig)
        self._installed = []

    # -- the profiled slice --

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm(self) -> None:
        """Start and stop the profiler once during set-up: its first start
        initialises the device tracer, which would otherwise land in the
        window."""
        import torch
        from torch.profiler import profile

        with profile(activities=self._activities()):
            (torch.ones(8, device=self.device) + 1).sum().item()

    def begin(self) -> None:
        import torch
        from torch.profiler import profile

        self.started = self.active = True
        self.t_begin = time.perf_counter()
        self._install()
        self._prof = profile(activities=self._activities())
        self._prof.start()
        self._slice = torch.profiler.record_function("lb/slice#0")
        self._slice.__enter__()

    def end(self) -> None:
        self._slice.__exit__(None, None, None)
        self._prof.stop()
        self._uninstall()
        self.active = False
        self._tick = None
        self.t_end = time.perf_counter()

    def reduce(self) -> "Summary":
        """Export the slice's trace under ``TMPDIR``, reduce it, delete it."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self._prof = None
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return reduce_events(events)


@dataclasses.dataclass
class Summary:
    """A profiled slice, reduced."""

    window_s: float  # the slice's length (its host span)
    busy_s: float  # time in which some device activity ran, within the slice
    kernels: int  # device kernels launched in the slice
    span_device_s: dict  # "kind#n" → device seconds of what it launched
    span_complete: dict  # "kind#n" → every launch inside came back as activity
    device_ops: list  # [name, seconds], the ten largest
    idle_gaps: list  # [what the host was doing, seconds], the ten largest
    launches_matched: float  # share of host launches whose activity came back


_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "user_annotation")
_RUNTIME = ("cuda_runtime", "cuda_driver")


def _label(name: str) -> str:
    return re.sub(r"[^0-9A-Za-z_:.]+", "_", name)[:64]


def _union(intervals: list, lo: float, hi: float) -> list:
    """Merged intervals of ``intervals`` clipped to [lo, hi]."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Innermost:
    """The host events open at a time on one thread, innermost last (they
    nest: one thread's ranges never cross)."""

    def __init__(self, events: list):
        self.ev = sorted(events, key=lambda e: (e[0], -e[1]))
        self.i = 0
        self.stack: list = []

    def at(self, t: float) -> list:
        """Open events at ``t``; ``t`` must not decrease between calls."""
        while self.i < len(self.ev) and self.ev[self.i][0] <= t:
            s, e, name = self.ev[self.i]
            while self.stack and self.stack[-1][1] <= s:
                self.stack.pop()
            self.stack.append((s, e, name))
            self.i += 1
        while self.stack and self.stack[-1][1] <= t:
            self.stack.pop()
        return [x for x in self.stack if x[1] > t]


def reduce_events(events: list) -> Summary:
    """Reduce a Chrome trace's events (timestamps in µs) to a ``Summary``."""
    host, spans, device = [], [], []
    runtime: dict = {}  # correlation → (start, name, tid)
    external: dict = {}  # external id → start
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts = float(e["ts"]) * 1e-6
        end = ts + float(e.get("dur", 0)) * 1e-6
        args = e.get("args") or {}
        name = e.get("name", "")
        if cat in _DEVICE:
            device.append((ts, end, name, cat, args.get("correlation"), args.get("External id")))
        elif cat in _RUNTIME:
            runtime[args.get("correlation")] = (ts, name, e.get("tid"))
        elif cat in _HOST:
            host.append((ts, end, name, e.get("tid")))
            if args.get("External id") is not None:
                external.setdefault(args["External id"], ts)
            m = _SPAN.match(name)
            if m and cat == "user_annotation":
                spans.append((ts, end, f"{m.group(1)}#{m.group(2)}", e.get("tid")))
    sl = [s for s in spans if s[2].startswith("slice#")]
    if not sl:
        raise ValueError("the trace holds no slice span")
    lo, hi, _, main = sl[0]
    by_kind: dict = {k: [] for k in KINDS}
    for s, e, name, tid in spans:
        kind = name.split("#")[0]
        if tid == main and kind in by_kind:
            by_kind[kind].append((s, e, name))
    for k in by_kind:
        by_kind[k].sort()
    starts = {k: [s for s, _, _ in v] for k, v in by_kind.items()}

    def enclosing(t: float) -> list:
        out = []
        for k, v in by_kind.items():
            i = bisect.bisect_right(starts[k], t) - 1
            if i >= 0 and v[i][1] >= t:
                out.append(v[i][2])
        return out

    span_s: dict = {}
    launched: dict = {}  # span → launches inside it
    matched: dict = {}  # span → launches whose activity came back
    seen = set()
    ops: dict = {}
    kernels = 0
    busy = []
    for ts, end, name, cat, corr, ext in device:
        if end <= lo or ts >= hi:
            continue
        busy.append((ts, end))
        ops[_label(name)] = ops.get(_label(name), 0.0) + (end - ts)
        kernels += cat == "kernel"
        if corr in runtime:
            at = runtime[corr][0]
            seen.add(corr)
        else:
            at = external.get(ext)
        if at is None:
            continue
        for sp in enclosing(at):
            span_s[sp] = span_s.get(sp, 0.0) + (end - ts)
    n_launch = n_seen = 0
    for corr, (ts, name, tid) in runtime.items():
        if tid != main or "Launch" not in name or not lo <= ts <= hi:
            continue
        n_launch += 1
        n_seen += corr in seen
        for sp in enclosing(ts):
            launched[sp] = launched.get(sp, 0) + 1
            matched[sp] = matched.get(sp, 0) + (corr in seen)
    complete = {sp: matched.get(sp, 0) == n for sp, n in launched.items()}
    merged = _union(busy, lo, hi)
    busy_s = sum(e - s for s, e in merged)
    # idle gaps, by what the host's main thread was doing when each began
    inner = _Innermost([(s, e, n) for s, e, n, tid in host if tid == main])
    gaps: dict = {}
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        open_ = inner.at(s)
        ours = [n for _, _, n in open_ if _SPAN.match(n) and not n.startswith("lb/slice")]
        other = [n for _, _, n in open_ if not _SPAN.match(n)]
        where = ours[-1][3:].split("#")[0] if ours else "host"
        label = f"{where}/{_label(other[-1]) if other else 'python'}"
        gaps[label] = gaps.get(label, 0.0) + (e - s)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return Summary(
        window_s=hi - lo, busy_s=busy_s, kernels=kernels, span_device_s=span_s,
        span_complete=complete, device_ops=top(ops), idle_gaps=top(gaps),
        launches_matched=(n_seen / n_launch) if n_launch else 0.0,
    )
