"""LM decode service: slot-based continuous batching.

The port of ``repro.serve.lm_engine``.  A fixed pool of decode SLOTS
shares one (L, B_slots, T, K, hd) KV cache; requests claim a free slot
(prefill), the decode step advances EVERY slot by one token per
iteration, and finished slots are recycled mid-flight — new requests join
between steps.

The reference vmaps a one-sequence decode over the slots.  Here one
batched forward runs every slot at its own position: per-slot positions,
per-slot valid KV lengths and per-slot cache writes
(``transformer.decode_step`` with a (B,) ``cache_len``).  Two things keep
it equal to the vmapped form:

* each slot routes as its own MoE group of one token, as it does under
  vmap, so the step's config turns ``decode_group`` off;
* free slots are stepped too and write their cache rows at their stale
  length; only the per-slot length mask keeps those writes harmless.

The engine runs on its params' device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import ShardingRules
from repro_torch.models import transformer as T
from repro_torch.models.layers import LMConfig


@dataclasses.dataclass
class DecodeRequest:
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class LMDecodeEngine:
    """Continuous-batching decode over a shared slot pool."""

    def __init__(self, cfg: LMConfig, params: Any, rules: ShardingRules,
                 n_slots: int = 4, max_ctx: int = 256):
        self.cfg = cfg
        self.params = params
        self.rules = rules
        self.n_slots = n_slots
        self.max_ctx = max_ctx
        self.device = params["embed"].device
        self.cache = T.make_cache(cfg, n_slots, max_ctx, device=self.device)
        self.slot_req: List[Optional[DecodeRequest]] = [None] * n_slots
        self.slot_len = np.zeros(n_slots, np.int32)      # filled cache length
        self.slot_budget = np.zeros(n_slots, np.int32)   # remaining new tokens
        self.last_token = np.zeros(n_slots, np.int32)
        self.steps = 0
        # host seconds in prefill and in decode steps (each ends in a read
        # of the chosen tokens, which waits for the device)
        self.prefill_s = 0.0
        self.decode_s = 0.0
        # every slot is its own MoE group, as under the reference's vmap
        self._step_cfg = cfg if cfg.moe is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, decode_group=0))

    # -- slot management -------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def submit(self, req: DecodeRequest) -> bool:
        """Claim a slot + prefill. False if the pool is full (caller queues)."""
        slot = self._free_slot()
        if slot is None:
            return False
        S = int(req.prompt.shape[0])
        if S > self.max_ctx:
            raise ValueError(f"prompt of {S} tokens exceeds max_ctx "
                             f"{self.max_ctx}")
        t0 = time.perf_counter()
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :],
                                 device=self.device)
        logits, (pk, pv) = T.prefill_step(self.params, prompt, self.cfg,
                                          self.rules)
        # write the prompt's KV into the slot at offset 0
        self.cache[0][:, slot, :S] = pk[:, 0].to(self.cache[0].dtype)
        self.cache[1][:, slot, :S] = pv[:, 0].to(self.cache[1].dtype)
        first = int(torch.argmax(logits[0]))
        self.prefill_s += time.perf_counter() - t0
        self.slot_req[slot] = req
        self.slot_len[slot] = S
        self.slot_budget[slot] = req.max_new_tokens
        self.last_token[slot] = first
        req.tokens.append(first)
        return True

    def step(self) -> int:
        """One decode iteration over all ACTIVE slots. Returns #active."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        t0 = time.perf_counter()
        token = torch.as_tensor(self.last_token[:, None], device=self.device)
        lens = torch.as_tensor(self.slot_len, device=self.device)
        logits, self.cache = T.decode_step(self.params, token, self.cache,
                                           lens, self._step_cfg, self.rules)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        self.decode_s += time.perf_counter() - t0
        self.steps += 1
        for i in active:
            req = self.slot_req[i]
            self.slot_len[i] += 1
            self.slot_budget[i] -= 1
            tok = int(nxt[i])
            req.tokens.append(tok)
            self.last_token[i] = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            out_of_ctx = self.slot_len[i] + 1 >= self.max_ctx
            if self.slot_budget[i] <= 0 or hit_eos or out_of_ctx:
                req.done = True
                self.slot_req[i] = None          # recycle mid-flight
        return len(active)

    def run(self, requests: List[DecodeRequest]) -> Dict[str, float]:
        """Serve a workload to completion with continuous batching."""
        queue = list(requests)
        served = 0
        occupancy = []
        while queue or any(r is not None for r in self.slot_req):
            while queue and self.submit(queue[0]):
                queue.pop(0)
                served += 1
            n = self.step()
            if n:
                occupancy.append(n)
        return {
            "requests": served,
            "decode_steps": self.steps,
            "mean_occupancy": float(np.mean(occupancy)) if occupancy else 0.0,
            "decode_tokens": int(sum(occupancy)),
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
        }
