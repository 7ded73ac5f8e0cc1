"""Continuous batching scheduler (counterpart of
``tpu_lutvq.runtime.batching``, default device programs).

A fixed number of sequence slots share one batched KV cache, a slab
(``n_slots × max_seq`` rows per layer) or a paged pool (``paged_blocks``
blocks shared by all slots).  Pending requests are admitted by a prefill
on a small slab cache whose rows are copied into the slot; every tick then
decodes all slots together, ``horizon`` steps at a time, with the tokens
sampled on the device.  Scheduling is host-side Python over numpy
positions; the device work is eager PyTorch, and on a CUDA device the
host reads the device back once per tick (the tick's tokens), so
``run(pipeline=True)`` can queue tick k+1 before tick k's tokens arrive.

What the reference fuses into one jitted dispatch (prefill + slot write +
first-token sample, a decode roll) runs here as the same operations in
order on the device's stream; the caches are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpu_lutvq_torch.models.kv_cache import write_cache_slots, write_cache_slots_stacked
from tpu_lutvq_torch.models.llama import (
    LlamaConfig,
    LlamaWeights,
    init_caches,
    init_stacked_caches,
    llama_decode_step,
    llama_forward,
)
from tpu_lutvq_torch.models.paged_cache import BlockAllocator, PagedKVCache
from tpu_lutvq_torch.runtime.generate import (
    bucket_window,
    make_chunked_prefill,
    sample_logits_vec,
)


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    # filled by the scheduler:
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Admit → step → collect loop over a fixed slot pool."""

    def __init__(
        self,
        cfg: LlamaConfig,
        weights: LlamaWeights,
        n_slots: int = 8,
        strategy: str = "auto",
        seed: int = 0,
        prefill_fn=None,
        step_fn=None,
        cache_factory=None,
        paged_blocks: Optional[int] = None,
        paged_block_size: int = 128,
        paged_cache_factory=None,
        attn: str = "auto",
        quality: str = "exact",
        prefill_chunk: Optional[int] = None,
        stacked_kv: bool = False,
    ):
        """``paged_blocks`` switches the KV cache to the paged pool: that many
        blocks of ``paged_block_size`` tokens per layer, shared by all slots.
        Each admitted request gets ``ceil((T0 + max_new) / BS) + 1`` blocks
        (the +1 absorbs horizon overshoot), freed when it completes; a freed
        slot's table points at the junk block 0.

        ``prefill_chunk``: prompts longer than this are admitted one at a
        time through :func:`make_chunked_prefill` (attention ``attn``);
        shorter ones keep the one-shot prefill, alone or in a wave.

        ``quality`` ("exact" | "fast") is the serving precision budget, passed
        to every prefill, wave, chunked admission and decode step: "fast"
        serves the ``dequant_mm`` projections with the W8A8 tables.

        ``stacked_kv``: the slab cache as ONE stacked ``(L, B, H, S, …)``
        container (``llama_forward``'s hybrid mode, ``batching.py:103-110``):
        admission prefills into a small stacked cache and copies every layer
        into the slots at once (``write_cache_slot(s)_stacked``), and decode
        reads each layer's planes in place.  The slab route only: with a
        paged pool, or with injected device programs, it raises as the
        reference does.

        ``prefill_fn``/``step_fn``/``cache_factory``/``paged_cache_factory``
        (tensor-parallel device programs) are not ported and raise."""
        if stacked_kv and paged_blocks is not None:
            raise ValueError(
                "stacked_kv applies to the slab cache; the paged pool is already a "
                "per-layer pool container"
            )
        if stacked_kv and any(f is not None for f in (prefill_fn, step_fn, cache_factory)):
            raise ValueError(
                "stacked_kv is the default-program slab route; injected (TP) programs "
                "bring their own caches"
            )
        if any(f is not None for f in (prefill_fn, step_fn, cache_factory,
                                       paged_cache_factory)):
            raise NotImplementedError(
                "injected device programs serve tensor-parallel meshes, which need "
                "`dist/`, not ported yet (ROADMAP: `dist/`)"
            )
        self.cfg = cfg
        self.weights = weights
        self.n_slots = n_slots
        self.attn = attn
        self.strategy = strategy
        self.quality = quality
        self.device = weights.embed.device
        self.pending: list[Request] = []
        self.active: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)  # next write position
        self.paged = paged_blocks is not None
        self.stacked_kv = stacked_kv
        # the admission prefills' small caches, and the slab's
        self._cache_factory = init_stacked_caches if stacked_kv else init_caches
        if self.paged:
            bs = paged_block_size
            self._bs = bs
            self._max_blocks = -(-cfg.max_seq // bs)
            dtype = torch.int8 if cfg.kv_dtype == "int8" else torch.bfloat16
            caches = [
                PagedKVCache.init(paged_blocks, n_slots, self._max_blocks, cfg.n_kv_heads,
                                  cfg.head_dim, bs, dtype=dtype, device=self.device)
                for _ in range(cfg.n_layers)
            ]
            # every layer's table holds the same rows: one tensor serves all
            self._tables = caches[0].block_tables
            self.caches = tuple(c._replace(block_tables=self._tables) for c in caches)
            self._alloc = BlockAllocator(paged_blocks)
            self._alloc_capacity = len(self._alloc.free)
            self._slot_blocks: list[Optional[list]] = [None] * n_slots
            self._slot_capacity = np.zeros(n_slots, np.int64)
        else:
            self.caches = self._cache_factory(cfg, n_slots, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._prefill_chunk = prefill_chunk
        self._chunked_prefill = None
        if prefill_chunk is not None:
            self._chunked_prefill = make_chunked_prefill(
                cfg, chunk=prefill_chunk, strategy=strategy, attn=attn, quality=quality
            )
        self.wave_admits = 0  # requests admitted through waves
        self.completed: list[Request] = []

    # -- public API --

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.cfg.max_seq:
            raise ValueError("request exceeds max_seq")
        if self.paged:
            need = self._blocks_needed(req)
            if need > self._alloc_capacity:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool has only "
                    f"{self._alloc_capacity} usable — it could never run"
                )
        self.pending.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or any(r is not None for r in self.active)

    def run(self, max_steps: int = 100000, horizon: int = 1,
            pipeline: bool = False) -> list[Request]:
        """Drive the scheduler to completion.

        ``pipeline=True`` queues tick k+1 before tick k's tokens are read
        back: slots carried over take their input token from tick k's
        on-device sampler output.  EOS and admission then react one tick
        late; a finished slot's extra tokens are dropped on the host, and
        stale writes are ordered before any re-admission's on the stream."""
        steps = 0
        if not pipeline:
            while self.has_work and steps < max_steps:
                self.step(horizon=horizon)
                steps += 1
            done, self.completed = self.completed, []
            return done
        prev = None
        while steps < max_steps:
            if prev is None and not self.has_work:
                break
            nxt = self._dispatch_tick(horizon, prev=prev)
            if prev is not None:
                self._collect_tick(prev)
            elif nxt is None:
                break  # nothing active and nothing admissible
            prev = nxt
            steps += 1
        if prev is not None:
            self._collect_tick(prev)
        done, self.completed = self.completed, []
        return done

    def step(self, horizon: int = 1) -> None:
        """One tick: admit, then decode ``horizon`` tokens for every active
        slot, then read the tokens back."""
        ticket = self._dispatch_tick(horizon, prev=None)
        if ticket is not None:
            self._collect_tick(ticket)

    # -- device programs --

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array → device tensor without waiting on the device (a
        pinned staging copy; a plain copy from pageable memory would
        synchronise the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _blocks_needed(self, req: Request) -> int:
        return min(-(-(len(req.prompt) + req.max_new_tokens) // self._bs) + 1,
                   self._max_blocks)

    def _admit_prefill(self, prompts: np.ndarray, last_idx=None):
        """Prefill ``prompts`` (k, T) on a fresh k-slot slab cache: the last
        position's logits, or each row's ``last_idx`` position's."""
        small = self._cache_factory(self.cfg, prompts.shape[0], device=self.device)
        toks = self._to_device(prompts)
        if last_idx is None:
            logits, small = llama_forward(self.cfg, self.weights, toks, small, 0,
                                          strategy=self.strategy, quality=self.quality)
            return logits[:, -1], small
        logits, small = llama_forward(
            self.cfg, self.weights, toks, small, 0, strategy=self.strategy,
            quality=self.quality, logits_mode="index", logits_idx=self._to_device(last_idx),
        )
        return logits[:, 0], small

    def _write_slots(self, small, slots: list[int], t: int, t0s=None, table_rows=None):
        """Copy the first ``t`` rows of ``small`` into ``slots``: the slab
        slots whole, or through the slots' new table rows into the pool
        (``t0s``: each request's own length; pad rows go to block 0)."""
        slots_dev = self._to_device(np.asarray(slots, np.int64))
        if self.stacked_kv:
            write_cache_slots_stacked(self.caches, small, slots_dev)
            return
        if not self.paged:
            for big, s in zip(self.caches, small):
                write_cache_slots(big, s, slots_dev)
            return
        self._tables[slots_dev] = self._to_device(table_rows)
        t0s_dev = None if t0s is None else self._to_device(np.asarray(t0s, np.int64))
        for pc, s in zip(self.caches, small):
            pc.write_slots(s, slots_dev, t, t0s=t0s_dev)

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> torch.Tensor:
        return sample_logits_vec(logits, self.generator,
                                 self._to_device(np.asarray(temps, np.float32)))

    def _decode(self, tok_vec, pos: np.ndarray, temps: np.ndarray, horizon: int,
                window: int) -> torch.Tensor:
        """``horizon`` decode steps with on-device sampling: (horizon, B)."""
        pos_dev = self._to_device(pos)
        temps_dev = self._to_device(temps)
        out = []
        for _ in range(horizon):
            logits, self.caches = llama_decode_step(
                self.cfg, self.weights, tok_vec, self.caches, pos_dev,
                strategy=self.strategy, attn=self.attn, window=window,
                quality=self.quality,
            )
            tok_vec = sample_logits_vec(logits, self.generator, temps_dev)
            out.append(tok_vec)
            pos_dev = pos_dev + 1
        return torch.stack(out)

    # -- scheduler internals --

    def _release_slot(self, slot: int) -> None:
        """Paged mode: return the slot's blocks to the pool and point its
        table at the junk block 0 (inactive slots keep decoding garbage rows,
        which must never land in reassigned blocks)."""
        if not self.paged or self._slot_blocks[slot] is None:
            return
        self._alloc.release(self._slot_blocks[slot])
        self._slot_blocks[slot] = None
        self._slot_capacity[slot] = 0
        self._tables[slot] = 0

    def _admit(self) -> list[tuple[list[int], list[Request], torch.Tensor]]:
        """Admit pending requests into free slots: a wave first
        (:meth:`_admit_wave_fifo`), then one request per free slot.  Returns
        the admissions as groups (slots, requests, first-token device
        vector); the tokens are read back with the tick's."""
        deferred = self._admit_wave_fifo()
        for slot in range(self.n_slots):
            if self.active[slot] is not None or not self.pending:
                continue
            req = self.pending.pop(0)
            t0 = len(req.prompt)
            table_row = None
            if self.paged:
                need = self._blocks_needed(req)
                if need > len(self._alloc.free):
                    # pool exhausted: wait for running requests to release
                    # blocks (backpressure, not a crash)
                    self.pending.insert(0, req)
                    break
                blocks = self._alloc.alloc(need)
                self._slot_blocks[slot] = blocks
                self._slot_capacity[slot] = len(blocks) * self._bs
                table_row = np.zeros((1, self._max_blocks), np.int32)
                table_row[0, : len(blocks)] = blocks
            prompt = np.asarray([req.prompt], np.int32)
            if self._chunked_prefill is not None and t0 > self._prefill_chunk:
                small = self._cache_factory(self.cfg, 1, device=self.device)
                logits, small = self._chunked_prefill(
                    self.weights, self._to_device(prompt), small
                )
            else:
                logits, small = self._admit_prefill(prompt)
            self._write_slots(small, [slot], t0, table_rows=table_row)
            tok = self._sample(logits, [req.temperature])
            self.active[slot] = req
            self.slot_pos[slot] = t0 + 1
            deferred.append(([slot], [req], tok))
        return deferred

    def _admit_wave_fifo(self):
        """Ragged admission wave (``batching.py:702-833``): the longest FIFO
        prefix of ``pending`` that fits the free slots, stops at the first
        prompt that needs the chunked prefill (no request is admitted past
        an earlier one) and, paged, at pool exhaustion, is admitted as one
        B=k prefill when k ≥ 2.  Prompts are right-padded with 0 to a
        power-of-two bucket; each request's first token comes from its own
        last real position, and its pad rows stay masked (slab) or go to
        the junk block (paged)."""
        if len(self.pending) < 2:
            return []
        free = [i for i, r in enumerate(self.active) if r is None]
        if len(free) < 2:
            return []
        k = 0
        for req in self.pending[: len(free)]:
            if self._chunked_prefill is not None and len(req.prompt) > self._prefill_chunk:
                break
            k += 1
        if k < 2:
            return []
        admitted_blocks = None
        table_rows = None
        if self.paged:
            admitted_blocks = []
            for req in self.pending[:k]:
                need = self._blocks_needed(req)
                if need > len(self._alloc.free):
                    break
                admitted_blocks.append(self._alloc.alloc(need))
            if len(admitted_blocks) < 2:
                for blocks in admitted_blocks:
                    self._alloc.release(blocks)
                return []
            k = len(admitted_blocks)
            table_rows = np.zeros((k, self._max_blocks), np.int32)
            for j, blocks in enumerate(admitted_blocks):
                table_rows[j, : len(blocks)] = blocks
        reqs = [self.pending.pop(0) for _ in range(k)]
        slots = free[:k]
        t_max = max(len(r.prompt) for r in reqs)
        bucket = 8
        while bucket < t_max:
            bucket *= 2
        bucket = min(bucket, self.cfg.max_seq)
        prompts = np.zeros((k, bucket), np.int32)
        for j, r in enumerate(reqs):
            prompts[j, : len(r.prompt)] = r.prompt
        t0s = [len(r.prompt) for r in reqs]
        logits, small = self._admit_prefill(prompts, last_idx=np.asarray(t0s, np.int64) - 1)
        if self.paged:
            for slot, blocks in zip(slots, admitted_blocks):
                self._slot_blocks[slot] = blocks
                self._slot_capacity[slot] = len(blocks) * self._bs
            self._write_slots(small, slots, bucket, t0s=t0s, table_rows=table_rows)
        else:
            self._write_slots(small, slots, bucket)
        toks = self._sample(logits, [r.temperature for r in reqs])
        for slot, req in zip(slots, reqs):
            self.active[slot] = req
            self.slot_pos[slot] = len(req.prompt) + 1
        self.wave_admits += k
        return [(slots, reqs, toks)]

    def _maybe_finish(self, req: Request, slot_len: int) -> None:
        if req.eos_id is not None and req.output and req.output[-1] == req.eos_id:
            req.done = True
        if len(req.output) >= req.max_new_tokens:
            req.done = True
        if slot_len >= self.cfg.max_seq:
            req.done = True

    def _dispatch_tick(self, horizon: int, prev=None):
        """Admit, then queue one decode tick; nothing is read back.

        Returns a ticket for :meth:`_collect_tick`, or None if nothing is
        active.  With ``prev`` (the previous ticket, not yet collected),
        slots carried over from it take their token from prev's device
        output and their position from prev's dispatch position + horizon."""
        deferred = self._admit()
        slots = [i for i, r in enumerate(self.active) if r is not None]
        if not slots:
            return None
        prev_slots = set(prev["slots"]) if prev is not None else set()
        # batched decode over all slots; inactive slots decode garbage at pos 0
        tokens = np.zeros(self.n_slots, np.int32)
        pos = np.zeros(self.n_slots, np.int32)
        temps = np.zeros(self.n_slots, np.float32)
        new_slots = {s for g_slots, _, _ in deferred for s in g_slots}
        chained = []  # slots whose token comes from prev's device output
        for i in slots:
            if i in new_slots:
                pos[i] = self.slot_pos[i] - 1
            elif prev is not None and i in prev_slots:
                pos[i] = int(prev["pos"][i]) + prev["h"]
                chained.append(i)
            else:
                tokens[i] = self.active[i].output[-1]
                pos[i] = self.slot_pos[i] - 1  # position of the token being fed
            temps[i] = self.active[i].temperature

        # a roll must never write rows past max_seq (paged: past the slot's
        # blocks); near the end of any sequence, fall back to single steps
        def cap(i):
            return int(self._slot_capacity[i]) if self.paged else self.cfg.max_seq

        if horizon > 1 and any(int(pos[i]) + horizon > cap(i) for i in slots):
            horizon = 1
        # the roll's last step reads rows 0..max(pos)+horizon-1
        window = bucket_window(max(int(pos[i]) for i in slots) + horizon, self.cfg.max_seq)
        if chained and not deferred and len(chained) == len(slots):
            tok_vec = prev["toks"][-1]  # steady state: feed prev's output straight in
        else:
            tok_vec = self._to_device(tokens)
            if chained:
                idx = self._to_device(np.asarray(chained, np.int64))
                tok_vec[idx] = prev["toks"][-1][idx]
        for g_slots, _, g_toks in deferred:
            idx = self._to_device(np.asarray(g_slots, np.int64))
            tok_vec[idx] = g_toks.to(torch.int32)
        toks = self._decode(tok_vec, pos, temps, horizon, window)
        return {
            "toks": toks,  # (horizon, B) on the device
            "deferred": deferred,
            "slots": slots,
            "reqs": {i: self.active[i] for i in slots},
            "h": horizon,
            "pos": pos,
        }

    def _collect_tick(self, ticket) -> None:
        """Read a queued tick's tokens back (one transfer) and do the host
        bookkeeping."""
        deferred = ticket["deferred"]
        parts = [ticket["toks"].reshape(-1)] + [g[2].reshape(-1) for g in deferred]
        flat = torch.cat([p.to(torch.int64) for p in parts]).cpu().numpy()
        toks = flat[: ticket["toks"].numel()].reshape(ticket["toks"].shape)
        at = toks.size
        for g_slots, g_reqs, _ in deferred:
            for i, req in zip(g_slots, g_reqs):
                req.output.append(int(flat[at]))
                at += 1
                self._maybe_finish(req, slot_len=int(self.slot_pos[i]))
        for i in ticket["slots"]:
            req = ticket["reqs"][i]
            if self.active[i] is not req:
                # pipelined staleness: the slot finished at an earlier
                # collect (and may host a newer request): overshoot
                continue
            for h in range(toks.shape[0]):
                if req.done:
                    break  # horizon overshoot past EOS/max: truncate
                req.output.append(int(toks[h, i]))
                self.slot_pos[i] += 1
                self._maybe_finish(req, slot_len=int(self.slot_pos[i]))
            if req.done:
                self.completed.append(req)
                self.active[i] = None
                self._release_slot(i)
