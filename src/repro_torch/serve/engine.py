"""Batched serving engine: slot-based continuous batching over decode_step.

The reference's ``serve/engine.py`` on the port's ``Model``.  A fixed pool
of B slots shares one decode cache and one ``Model.decode_step``: the batch
is always B wide, so the step sees one input shape, and the step writes the
cache in place, so its tensors keep their storage from the first step to
the last (the counterpart of the reference's one compiled graph).  Requests
join free slots in submission order; a prompt is fed token by token through
the same step; finished or empty slots decode padding tokens whose outputs
are ignored.  Per-slot state (remaining budget, emitted tokens) lives on the
host: the device sees only (tokens, cache), and the host reads the step's
logits once per step, the step's one synchronisation.

Greedy by default; temperature sampling draws on the host from
``numpy.random.default_rng(seed)``, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import Model


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serves ``model`` (its weights loaded) on the model's device: the card
    unless the model was built with ``device="cpu"``."""

    def __init__(self, model: Model, *, batch_slots: int = 4,
                 cache_len: int = 256, greedy: bool = True, seed: int = 0):
        self.model = model
        self.b = batch_slots
        self.cache_len = cache_len
        self.greedy = greedy
        self.rng = np.random.default_rng(seed)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self._next_id = 0
        self.cache = model.init_cache(batch_slots, cache_len)
        self.steps = 0

    # -- client API -----------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        req = Request(self._next_id, list(prompt), max_new_tokens)
        self._next_id += 1
        self.queue.append(req)
        return req.req_id

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Decode until all submitted requests finish.  Returns outputs."""
        finished: Dict[int, List[int]] = {}
        pending_prefill: Dict[int, List[int]] = {}  # slot -> prompt remainder
        last_token = np.zeros(self.b, np.int32)
        dev = self.cache["pos"].device
        vocab = self.model.cfg.vocab_size
        # the step's tokens go up from pinned memory without a wait; the
        # buffer is rewritten only after the step's logits were read
        tok_host = torch.empty(self.b, dtype=torch.int32, pin_memory=dev.type == "cuda")

        for _ in range(max_steps):
            # admit queued requests into free slots (prompt fed token by token
            # through the same decode step)
            for i in range(self.b):
                if self.slots[i] is None and self.queue:
                    req = self.queue.pop(0)
                    self.slots[i] = req
                    pending_prefill[i] = list(req.prompt)
                    last_token[i] = pending_prefill[i].pop(0) if req.prompt else 0
                    self._reset_slot(i)
            if all(s is None for s in self.slots):
                break

            tok_host.copy_(torch.from_numpy(last_token))
            logits, self.cache = self.model.decode_step(
                self.cache, tok_host.to(dev, non_blocking=True))
            self.steps += 1
            lg = logits.float().cpu().numpy()

            for i, req in enumerate(self.slots):
                if req is None:
                    last_token[i] = 0
                    continue
                if pending_prefill.get(i):
                    last_token[i] = pending_prefill[i].pop(0)  # still prefill
                    continue
                tok = int(lg[i, :vocab].argmax()) if self.greedy else self._sample(lg[i])
                req.out_tokens.append(tok)
                last_token[i] = tok
                if len(req.out_tokens) >= req.max_new_tokens:
                    req.done = True
                    finished[req.req_id] = req.out_tokens
                    self.slots[i] = None
                    pending_prefill.pop(i, None)
        return finished

    def _reset_slot(self, i: int):
        """Fresh sequence state for a newly admitted request: position 0 and
        a cleared SSM state, in place.  Stale KV entries need no clearing:
        the per-slot position mask hides everything past pos, and slots are
        overwritten as the new sequence advances."""
        self.cache["pos"][i] = 0
        if "ssm" in self.cache:
            self.cache["ssm"][:, i] = 0.0

    def _sample(self, logits: np.ndarray, temp: float = 1.0) -> int:
        v = self.model.cfg.vocab_size
        p = logits[:v] / temp
        p = np.exp(p - p.max())
        p /= p.sum()
        return int(self.rng.choice(v, p=p))
