"""Batched serving engine: continuous batching over fixed decode slots.

Counterpart of ``repro.serving.engine``.  A fixed number of decode slots
(the batch dimension) advance together, one ``decode_step`` per step, each
at its own position (``pos: int[B]``); an ``active`` mask confines cache
writes to live slots.  A host-side queue fills free slots (prompts are
replayed through the decode path in lockstep, so the cache layout stays
uniform), and finished sequences (EOS or budget) free them.

Sampling: greedy (argmax) or temperature sampling from the engine's own
``torch.Generator``.  Nothing is compiled: each step runs the model's
torch ops eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import LanguageModel

__all__ = ["ServeEngine", "Request"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # int[prompt_len]
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 => greedy
    out_tokens: Optional[List[int]] = None


class ServeEngine:
    def __init__(self, lm: LanguageModel, params=None, *, slots: int = 4,
                 max_len: int = 512, eos_id: int = -1, seed: int = 0):
        """``params``: None (``lm``'s own weights) or a state dict loaded
        into ``lm`` (``LanguageModel.bind``)."""
        cfg = lm.cfg
        if not cfg.supports_decode():
            raise ValueError(f"{cfg.name} is encoder-only; cannot serve decode")
        self.lm = lm.bind(params)
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.caches = lm.init_cache(slots, max_len)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros((slots,), np.int64)   # next position to write
        self.gen = torch.Generator().manual_seed(seed)
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self.decode_steps = 0                          # decode_step calls

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.out_tokens = []
        self.queue.append(req)

    def _run_tokens(self, tokens: np.ndarray, pos: np.ndarray, active: np.ndarray):
        batch = {"tokens": tokens.reshape(self.slots, 1), "pos": pos, "active": active}
        logits, self.caches = self.lm.decode_step(batch, self.caches)
        self.decode_steps += 1
        return logits

    def _admit(self) -> None:
        """Fill every free slot, then replay the admitted prompts through the
        decode path in lockstep: one step per prompt position with every
        still-replaying slot active (the others masked, their caches
        untouched), max(prompt_len) - 1 steps in all, not the sum."""
        admitted: List[Tuple[int, Request]] = []
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[s] = req
                admitted.append((s, req))
        if not admitted:
            return
        max_replay = max(len(req.prompt) - 1 for _, req in admitted)
        for t in range(max_replay):
            active = np.zeros((self.slots,), bool)
            toks = np.zeros((self.slots,), np.int64)
            pos = self.slot_pos.copy()
            for s, req in admitted:
                if t < len(req.prompt) - 1:
                    active[s] = True
                    toks[s] = int(req.prompt[t])
                    pos[s] = t
            self._run_tokens(toks, pos, active)
        for s, req in admitted:
            self.slot_pos[s] = max(len(req.prompt) - 1, 0)

    # ------------------------------------------------------------------
    def _sample(self, logits_row: np.ndarray, temp: float) -> int:
        if temp <= 0:
            return int(np.argmax(logits_row))
        p = torch.softmax(torch.from_numpy(logits_row) / temp, dim=-1)
        return int(torch.multinomial(p, 1, generator=self.gen))

    def step(self) -> int:
        """One decode step over all active slots; returns the number active."""
        self._admit()
        active_idx = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active_idx:
            return 0
        active = np.zeros((self.slots,), bool)
        toks = np.zeros((self.slots,), np.int64)
        for s in active_idx:
            req = self.slot_req[s]
            active[s] = True
            toks[s] = req.out_tokens[-1] if req.out_tokens else int(req.prompt[-1])
        logits = self._run_tokens(toks, self.slot_pos.copy(), active)
        lg = logits[:, 0, : self.lm.cfg.vocab_size].float().cpu().numpy()
        for s in active_idx:
            req = self.slot_req[s]
            nxt = self._sample(lg[s], req.temperature)
            req.out_tokens.append(nxt)
            self.slot_pos[s] += 1
            if len(req.out_tokens) >= req.max_new_tokens or nxt == self.eos_id:
                self.done[req.rid] = req
                self.slot_req[s] = None
                self.slot_pos[s] = 0
        return len(active_idx)

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        return self.done
