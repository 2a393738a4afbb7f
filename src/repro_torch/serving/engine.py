"""Batched serving engine: continuous-batching-style decode over a fixed
slot grid.

Requests are admitted into B fixed slots; prefill fills a slot's KV cache
(computed right-padded to the slot length), decode steps advance all
active slots together, finished slots (EOS or budget) are recycled.  The
cache is allocated once at (B, max_len) on the model's device —
admission never reallocates.  Slot activity is a list of requests;
inactive slots decode garbage that is masked out of the responses
(standard padded-batch serving).

The engine is the JAX package's, step for step, run eagerly (no graph
capture yet):

* The cache is bfloat16 (``init_cache``'s default), so every prefilled
  K / V is rounded to bf16 when it is spliced into a slot.
* Every decode step runs all slots at ONE common position: at each
  admission the cache position is set to the longest prompt among the
  active slots, and it advances by one per step.  A slot with a shorter
  prompt then attends over zero-padded cache rows, and a slot admitted
  while others decode resets their position.  This is the JAX package's
  behaviour, reproduced as it is.
* The model's weights are cast to its compute dtype once, at
  construction (``Model.compute_params``): the same values as the JAX
  package's cast at each use.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.models.transformer import tree_map


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new_tokens: int = 16
    out_tokens: list = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None


class ServeEngine:
    def __init__(self, model, params, *, n_slots: int = 4,
                 max_len: int = 256, eos_id: int = -1, metrics=None):
        self.model = model
        self.params = params
        self._params = model.compute_params(params)
        self.device = model.device
        self.B = n_slots
        self.max_len = max_len
        self.eos = eos_id
        self.cache = model.init_cache(n_slots, max_len)
        self.active: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int64)
        self.slot_budget = np.zeros(n_slots, np.int64)
        self.last_token = np.zeros((n_slots, 1), np.int32)
        # opt-in repro_torch.obs.MetricsRegistry: request/token counters +
        # admit->done latency histogram; None records nothing
        self.metrics = metrics
        self._t_admit: dict[int, float] = {}

    # -- prefill -------------------------------------------------------
    def _prefill_one(self, tokens):
        """Prefill one request: (last-position logits, its cache)."""
        return self.model.prefill(self._params, {"tokens": tokens})

    def _splice(self, slot: int, prefill_cache, prompt_len: int):
        """Copy one request's prefill cache into the engine's slot, zero
        past its length (the JAX package's padded copy, in place)."""
        def copy(dst, src):
            # leaves: (R, B, S, ...) dst vs (R, 1, P, ...) src
            if dst.ndim < 2 or src.shape[0] != dst.shape[0] or \
                    dst.ndim != src.ndim or src.shape[2] > dst.shape[2]:
                return
            row = dst[:, slot:slot + 1]
            row[:, :, :src.shape[2]] = src.to(dst.dtype)
            row[:, :, src.shape[2]:] = 0

        tree_map(copy, self.cache["blocks"], prefill_cache["blocks"])

    def admit(self, req: Request) -> bool:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            # _splice cannot represent a prompt longer than the slot, and
            # decode positions past max_len write out of the cache range:
            # reject up front.
            req.error = (f"prompt length {len(req.prompt)} + "
                         f"max_new_tokens {req.max_new_tokens} exceeds "
                         f"engine max_len {self.max_len}")
            req.done = True
            if self.metrics is not None:
                self.metrics.counter("serve.rejected").inc()
            return False
        for slot in range(self.B):
            if self.active[slot] is None:
                tokens = torch.as_tensor(
                    np.asarray(req.prompt, np.int32)[None, :]).to(self.device)
                logits, pc = self._prefill_one(tokens)
                self._splice(slot, pc, len(req.prompt))
                first = int(torch.argmax(logits[0]))
                req.out_tokens.append(first)
                self.active[slot] = req
                self.slot_pos[slot] = len(req.prompt)
                self.slot_budget[slot] = req.max_new_tokens - 1
                self.last_token[slot, 0] = first
                # one position for all slots: the longest active prompt
                self.cache = dict(
                    self.cache,
                    pos=int(max(self.slot_pos[s] for s in range(self.B)
                                if self.active[s] is not None)))
                if self.metrics is not None:
                    self.metrics.counter("serve.requests").inc()
                    self.metrics.counter("serve.prompt_tokens").inc(
                        len(req.prompt))
                    self._t_admit[req.rid] = time.perf_counter()
                return True
        return False

    def step(self):
        """One decode step for all active slots."""
        if not any(r is not None for r in self.active):
            return
        token = torch.as_tensor(self.last_token).to(self.device)
        logits, self.cache = self.model.decode_step(self._params, self.cache,
                                                    token)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        if self.metrics is not None:
            self.metrics.counter("serve.decode_steps").inc()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.out_tokens.append(tok)
            self.slot_budget[slot] -= 1
            self.last_token[slot, 0] = tok
            if self.metrics is not None:
                self.metrics.counter("serve.tokens").inc()
            if tok == self.eos or self.slot_budget[slot] <= 0:
                req.done = True
                self.active[slot] = None
                if self.metrics is not None:
                    t0 = self._t_admit.pop(req.rid, None)
                    if t0 is not None:
                        self.metrics.histogram(
                            "serve.request_latency_s").observe(
                                time.perf_counter() - t0)

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve a request list to completion (simple FCFS admission)."""
        pending = list(requests)
        done: list[Request] = []
        while pending or any(r is not None for r in self.active):
            while pending and (self.admit(pending[0]) or pending[0].done):
                pending.pop(0)          # admitted, or rejected with error
            self.step()
            for r in requests:
                if r.done and r not in done:
                    done.append(r)
        return done
