"""Batched LM serving loop: prefill + greedy decode over batch slots.

A fixed pool of batch slots serves a request queue in slot-sized
batches: each batch's prompts are left-padded to the longest, prefilled
together, and every decode step advances all live sequences of the
batch together.  A port of ``repro.serving.server`` in eager PyTorch:
``prefill`` and ``decode_step`` run op by op on ``device``, and the
decode cache is allocated once per batch and updated in place.
"""
from __future__ import annotations

import time
from collections import deque
from typing import List

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.backend import resolve_device
from ..models import lm
from .common import LmRequest as Request  # shared serving primitives


class BatchServer:
    """Slot-based LM batch server over eager prefill/decode.

    ``params`` must live on ``device`` (default the card; without one
    this raises unless ``device="cpu"``).  Units and clocks: request
    ``latency_s`` is **wall-clock seconds** measured around each served
    batch with ``time.time()``.  Thread-safety: not thread-safe; one
    server instance per thread.
    """

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 4,
                 max_len: int = 256, device=None):
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        where = params["embed"].device
        if where.type != self.device.type:
            raise ValueError(f"params live on {where}, the server on "
                             f"{self.device}")

    def serve(self, requests: List[Request], greedy: bool = True
              ) -> List[Request]:
        """Serve all ``requests`` to completion in slot-sized batches;
        fills each request's ``output`` tokens and wall-clock
        ``latency_s``, returning the requests in completion order."""
        queue = deque(requests)
        done: List[Request] = []
        while queue:
            batch = [queue.popleft() for _ in range(min(self.slots,
                                                        len(queue)))]
            t0 = time.time()
            self._serve_batch(batch)
            for r in batch:
                r.latency_s = time.time() - t0
            done.extend(batch)
        return done

    @torch.no_grad()
    def _serve_batch(self, batch: List[Request]) -> None:
        b = len(batch)
        plen = max(len(r.prompt) for r in batch)
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(batch):
            toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
        logits, cache = lm.prefill(
            self.params, self.cfg,
            {"tokens": torch.from_numpy(toks).to(self.device)},
            cache_len=self.max_len)
        outputs = [[] for _ in batch]
        live = np.ones(b, bool)
        cur = logits[:, -1].argmax(dim=-1).cpu().numpy()
        for i in range(b):
            outputs[i].append(int(cur[i]))
        max_new = max(r.max_new_tokens for r in batch)
        pos = plen
        for _ in range(max_new - 1):
            if not live.any() or pos >= self.max_len:
                break
            step_batch = {"tokens": torch.from_numpy(
                cur[:, None].astype(np.int64)).to(self.device)}
            logits, cache = lm.decode_step(self.params, self.cfg, cache,
                                           step_batch, pos)
            cur = logits[:, 0].argmax(dim=-1).cpu().numpy()
            pos += 1
            for i, r in enumerate(batch):
                if not live[i] or len(outputs[i]) >= r.max_new_tokens:
                    live[i] = live[i] and len(outputs[i]) < r.max_new_tokens
                    continue
                outputs[i].append(int(cur[i]))
                if r.eos is not None and cur[i] == r.eos:
                    live[i] = False
        for r, out in zip(batch, outputs):
            r.output = out
