"""Batched serving engine: a continuous-batching decode loop over a
KV-cache.

Counterpart of ``src/repro/serve/engine.py``.  Requests join a fixed-slot
batch; prompts are fed token by token through ``decode_step`` (prefill is
forced decode), then sampled greedily (``argmax``) or by temperature
until EOS or ``max_len``; finished slots are refilled from the queue.
Slot state (position, prompt tokens fed) lives on the host.

Each slot is an independent **lane** at its own position.  The
reference maps ``decode_step`` over one B = 1 cache per lane with
``jax.vmap``; here the lanes are the batch rows of one cache and
``decode_step`` takes a (B,) position tensor, so each row's rope, cache
write, validity mask and window are its own — a request admitted into a
drained slot starts at position 0 while its neighbours keep decoding at
theirs, and produces the tokens it would produce alone.  A refilled
lane's cache rows are zeroed first (a KV row past its position is masked
anyway; a recurrent state would otherwise carry the previous request's).

With ``lane_params_fn`` (the multi-tenant hook, ``serve/service.py``)
each lane decodes under its own request's weights.  The reference
gathers every lane's parameters into an (L, …) stack; at 9.1 GB a
gemma3-4b tenant that is not possible, so the hook returns, for each
distinct parameter set in the batch, that set (views) and its lanes, and
the engine runs one ``decode_step`` per set over those lanes' rows of
the cache (gathered and scattered back: a few hundred KB a layer a
lane).  So a tick's launches grow with the number of distinct tenants in
the batch, not with the lanes.

Temperature sampling draws from one ``torch.Generator`` seeded from
``seed`` (``jax.random.categorical`` cannot be reproduced), so parity
with the reference holds for greedy requests.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.lm import LM


def init_lane_cache(lm: LM, lanes: int, max_len: int):
    """The per-lane decode cache: ``lanes`` batch rows of one cache, each
    advanced at its own position by ``decode_step``'s (B,) positions.
    (The reference stacks ``lanes`` B = 1 caches on a new leading axis
    for its ``vmap``.)"""
    return lm.init_cache(lanes, max_len)


def _cache_map(fn, cache):
    """{segment: {pattern position: {name: (repeats, B, …)}}} → the same
    nest of ``fn(leaf)``."""
    return {s: {p: {k: fn(v) for k, v in c.items()} for p, c in seg.items()}
            for s, seg in cache.items()}


def _cache_leaves(cache):
    return [v for seg in cache.values() for c in seg.values()
            for v in c.values()]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new: int = 32
    temperature: float = 0.0
    tenant: Optional[int] = None       # bank slot (multi-tenant service)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_done: float = 0.0


#: lane_params_fn(slots) → [(params, lanes), …]: each distinct parameter
#: set in the batch with the slot indices that decode under it
LaneParamsFn = Callable[[Sequence[Optional[Request]]],
                        List[Tuple[dict, List[int]]]]


class Engine:
    def __init__(self, lm: LM, params, batch_slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 seed: int = 0, writer=None,
                 lane_params_fn: Optional[LaneParamsFn] = None):
        self.lm = lm
        self.params = params
        self.B = batch_slots
        self.S = max_len
        self.eos = eos_id
        self.writer = writer      # repro_torch.obs TelemetryWriter
        self._lane_params_fn = lane_params_fn
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._slots: List[Optional[Request]] = [None] * batch_slots
        self._fed: List[int] = [0] * batch_slots      # prompt tokens fed
        self._pos: List[int] = [0] * batch_slots
        self._t_start: List[float] = [0.0] * batch_slots
        self._cache = init_lane_cache(lm, batch_slots, max_len)
        self._gen = torch.Generator().manual_seed(seed)
        self.completed: Dict[int, Request] = {}

    def submit(self, req: Request):
        req.t_submit = time.time()
        self._queue.put(req)

    def _fill_slots(self):
        fresh = []
        for i in range(self.B):
            if self._slots[i] is None and not self._queue.empty():
                self._slots[i] = self._queue.get()
                self._fed[i] = 0
                self._pos[i] = 0
                self._t_start[i] = time.time()
                fresh.append(i)
        if fresh:
            rows = torch.tensor(fresh, device=self.lm.device)
            for v in _cache_leaves(self._cache):
                v.index_fill_(1, rows, 0)

    def _decode(self, params, lanes: List[int], tokens, ts):
        """Logits (len(lanes), V) of one decode step of ``lanes`` under
        ``params``; their cache rows are advanced."""
        dev = self.lm.device
        tok = torch.as_tensor(tokens[lanes], device=dev)[:, None]
        pos = torch.as_tensor(ts[lanes], device=dev)
        if lanes == list(range(self.B)):
            logits, _ = self.lm.decode_step(params, self._cache, tok, pos)
            return logits[:, 0]
        rows = torch.tensor(lanes, device=dev)
        sub = _cache_map(lambda v: v.index_select(1, rows), self._cache)
        logits, sub = self.lm.decode_step(params, sub, tok, pos)
        for v, w in zip(_cache_leaves(self._cache), _cache_leaves(sub)):
            v.index_copy_(1, rows, w)
        return logits[:, 0]

    def step(self):
        """One engine tick: one decode step for every lane (one
        ``decode_step`` per distinct parameter set)."""
        self._fill_slots()
        tokens = np.zeros((self.B,), np.int64)
        ts = np.zeros((self.B,), np.int64)
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            ts[i] = self._pos[i]
            if self._fed[i] < len(req.prompt):
                tokens[i] = req.prompt[self._fed[i]]
            elif req.out_tokens:
                tokens[i] = req.out_tokens[-1]
            else:
                tokens[i] = req.prompt[-1]
        if self._lane_params_fn is None:
            groups = [(self.params, list(range(self.B)))]
        else:
            groups = self._lane_params_fn(self._slots)
        logits = [None] * self.B
        for params, lanes in groups:
            out = self._decode(params, list(lanes), tokens, ts)
            out = out.float().cpu().numpy()
            for j, i in enumerate(lanes):
                logits[i] = out[j]
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            self._pos[i] += 1
            if self._fed[i] < len(req.prompt):
                self._fed[i] += 1
                continue                      # still prefill — no sampling
            if req.temperature > 0:
                probs = torch.softmax(
                    torch.from_numpy(logits[i]) / req.temperature, dim=-1)
                tok = int(torch.multinomial(probs, 1, generator=self._gen))
            else:
                tok = int(np.argmax(logits[i]))
            req.out_tokens.append(tok)
            done = (len(req.out_tokens) >= req.max_new or
                    (self.eos is not None and tok == self.eos) or
                    self._pos[i] >= self.S - 1)
            if done:
                req.t_done = time.time()
                self.completed[req.uid] = req
                self._slots[i] = None
                if self.writer is not None:
                    extra = {} if req.tenant is None \
                        else {"tenant": int(req.tenant)}
                    self.writer.emit(
                        "serve_request", uid=req.uid,
                        wait_s=self._t_start[i] - req.t_submit,
                        total_s=req.t_done - req.t_submit,
                        n_new=len(req.out_tokens), **extra)

    def latency_report(self) -> Dict[str, float]:
        """Request-latency percentiles over everything completed so far
        (the numbers ``repro_torch.obs.summary`` derives from the
        ``serve_request`` events)."""
        tot = sorted(r.t_done - r.t_submit
                     for r in self.completed.values())
        if not tot:
            return {"requests": 0}
        pct = lambda q: tot[min(len(tot) - 1,
                                int(round(q * (len(tot) - 1))))]
        return {"requests": len(tot), "p50_s": pct(0.5),
                "p99_s": pct(0.99)}

    def run_until_drained(self, max_ticks: int = 10_000):
        ticks = 0
        while (not self._queue.empty() or
               any(s is not None for s in self._slots)):
            self.step()
            ticks += 1
            if ticks >= max_ticks:
                break
        return ticks
