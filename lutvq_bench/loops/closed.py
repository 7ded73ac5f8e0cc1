"""A closed loop: each client sends its next request as soon as its last
one has finished, so a fixed number of requests is always in flight.

The batcher is driven tick by tick through ``submit()`` and ``step()``
(never ``run()``, which drains its queue and takes no arrivals): a request
is submitted between ticks as it falls due, and the next ``step()`` admits
it.  Clients start staggered, one new client a tick, so the first wave is
not one padded prefill of every client; the window opens at the end of
the tick that admits the last client's first request.  Tokens count when
the host holds them: at the end of the tick that read them back.

What a tick admitted and decoded is read from the batcher's own ticket
for that tick (the prompts it admitted, the slots it decoded at their
positions, the steps it ran), kept as the batcher collects it.  Where the
batcher has no such ticket, those fields stay empty and the readers that
need them read nothing.
"""

from __future__ import annotations

import time

from lutvq_bench.core.record import Served, Tick


def _watch(batcher, tickets: list) -> bool:
    """Keep each ticket the batcher collects in ``tickets``; False where it
    collects none by that name."""
    orig = getattr(batcher, "_collect_tick", None)
    if orig is None:
        return False

    def collect(ticket):
        tickets.append(ticket)
        return orig(ticket)

    batcher._collect_tick = collect
    return True


def _view(ticket) -> tuple:
    """(prompt lengths admitted, in admission order; positions of the slots
    decoded at the first step; decode steps) of a tick's ticket; a tick
    that collected nothing admitted and decoded nothing."""
    if ticket is None:
        return [], [], 0
    admitted = [len(r.prompt) for _, reqs, _ in ticket["deferred"] for r in reqs]
    return admitted, [int(ticket["pos"][i]) for i in ticket["slots"]], int(ticket["h"])


def drive(batcher, request_cls, schedule, mix: dict, rec, seconds: float, tracer=None) -> list:
    """Run the ramp and then the window of ``seconds``; fill ``rec``.
    Returns the finished ``Request`` objects (the program's outputs)."""
    clients = mix["clients"]
    horizon = mix["horizon"]
    inflight = {}  # client -> (Request, Served)
    next_k = [0] * clients
    finished = []
    window_ticks = 0
    tickets: list = []
    rec.batcher_seen = _watch(batcher, tickets)

    def submit(client: int) -> None:
        prompt, n_out = schedule.request(client, next_k[client])
        next_k[client] += 1
        req = request_cls(req_id=len(rec.served), prompt=prompt, max_new_tokens=n_out)
        s = Served(req.req_id, client, len(prompt), n_out, submit_t=time.perf_counter())
        batcher.submit(req)
        rec.served.append(s)
        inflight[client] = (req, s)

    ramped = 0
    while True:
        if ramped < clients:
            submit(ramped)
            ramped += 1
        tick = Tick(len(rec.ticks), 0.0, 0.0, None, None, None, 0, batcher.n_slots)
        tracing = tracer is not None and tracer.active
        tickets.clear()
        t0 = time.perf_counter()
        if tracing:
            with tracer.tick(tick.index):
                batcher.step(horizon=horizon)
        else:
            batcher.step(horizon=horizon)
        t1 = time.perf_counter()
        tick.start, tick.end, tick.traced = t0, t1, tracing
        if rec.batcher_seen:
            tick.admitted, tick.positions, tick.steps = _view(tickets[-1] if tickets else None)
        for client, (req, s) in list(inflight.items()):
            new = len(req.output) - s.n_out
            if new:
                s.receipts.append((t1, new))
                tick.tokens += new
            if req.done:
                s.done_t = t1
                finished.append(req)
                del inflight[client]
                submit(client)
        rec.ticks.append(tick)
        if not rec.window_open:
            if ramped == clients:
                rec.window_open = t1
            continue
        window_ticks += 1
        if tracer is not None:
            # the slice is the same ticks in every run (the ticks' work is
            # fixed), so runs and commits compare like for like
            start = mix["trace"]["after_ticks"]
            if window_ticks == start:
                tracer.begin()
            elif window_ticks == start + mix["trace"]["ticks"] and tracer.active:
                tracer.end()
                rec.slice_span = (tracer.t_begin, tracer.t_end)
        if t1 >= rec.window_open + seconds:
            rec.window_end = t1
            break
    if tracer is not None and tracer.active:
        tracer.end()
        rec.slice_span = (tracer.t_begin, tracer.t_end)
    return finished
