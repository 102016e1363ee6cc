"""Batched serving engine of the port: prefill + greedy decode with KV
caches, step for step as the reference's ``repro/serving/engine.py``.

The request queue is event-driven (``EventCoordinator`` — the Mwait
analogue): the engine thread sleeps until requests arrive instead of
polling.  Each ``run_once`` drains up to ``batch_size`` requests, right-
pads their prompts into one grid, prefills it (``Model.prefill``: the
``rglru_scan``, ``flash_attention`` and ``rwkv6_wkv`` kernels on the
card), takes each sequence's logits at its own last position, and
decodes greedily with a per-sequence position (``Model.decode_step``,
plain torch).  As in the reference, the encoder-decoder (``frontend ==
"audio"``) is given zero frame embeddings ``(b, encoder.seq_len, d)``,
and the VLM zero patch embeddings ``(b, min(num_patches, longest
prompt), d)``, in the compute dtype (``frontend_inputs``).

The engine runs on the GPU unless the caller passes ``device="cpu"``;
without a GPU the default raises.  The model must live on that device.
Recurrent layers need equal-length prompts in one batch, as in the
reference (a right-padded prompt would run its pads through the
recurrence).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sim import resolve_device
from repro_torch.distributed import EventCoordinator
from repro_torch.models import Model


def frontend_inputs(cfg: ModelConfig, batch: int, max_prompt: int,
                    device) -> dict:
    """What the engine feeds the frontend stub beside the tokens, as the
    reference engine does: zero frame embeddings ``encoder_feats`` (B,
    encoder.seq_len, d) for ``frontend == "audio"``, zero
    ``patch_embeds`` (B, min(num_patches, max_prompt), d) for ``"vlm"``,
    in the compute dtype; nothing for the others."""
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.frontend == "audio":
        return {"encoder_feats": torch.zeros(
            (batch, cfg.encoder.seq_len, cfg.d_model), dtype=cdt,
            device=device)}
    if cfg.frontend == "vlm":
        return {"patch_embeds": torch.zeros(
            (batch, min(cfg.num_patches, max_prompt), cfg.d_model),
            dtype=cdt, device=device)}
    return {}


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    id: int = 0
    result: Optional[np.ndarray] = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: Model, *, batch_size: int = 4,
                 cache_len: int = 256, device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.model = model
        self.batch = batch_size
        self.cache_len = cache_len
        self.coord = EventCoordinator()
        self.requests: "queue.Queue[Request]" = queue.Queue()
        self._stop = False

    # ------------------------------------------------------------- client
    def submit(self, req: Request):
        self.requests.put(req)
        self.coord.notify("request_arrived", qsize=self.requests.qsize())

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 16
                 ) -> np.ndarray:
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens)
        self.submit(req)
        req.done.wait()
        return req.result

    # ------------------------------------------------------------- engine
    def run_once(self) -> int:
        """Drain up to ``batch`` requests, serve them, return count
        (greedy decoding; prompts right-padded into a common grid)."""
        batch: List[Request] = []
        while len(batch) < self.batch and not self.requests.empty():
            batch.append(self.requests.get())
        if not batch:
            return 0
        b = len(batch)
        dev = self.model.device
        lens = np.array([len(r.prompt) for r in batch], np.int32)
        # RIGHT pad: causal attention keeps pad K/V invisible to real tokens,
        # and per-seq decode positions overwrite pad slots before attending
        # to them.
        max_prompt = int(lens.max())
        toks = np.zeros((b, max_prompt), np.int32)
        for i, r in enumerate(batch):
            toks[i, : len(r.prompt)] = r.prompt
        hidden, cache = self.model.prefill(
            torch.from_numpy(toks).to(dev), self.cache_len,
            **frontend_inputs(self.cfg, b, max_prompt, dev))
        last = torch.from_numpy(lens - 1).to(dev).long()
        h_last = hidden[torch.arange(b, device=dev), last][:, None]  # (B,1,d)
        logits = self.model.logits(h_last)
        outs = [[] for _ in range(b)]
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        max_new = max(r.max_new_tokens for r in batch)
        for step in range(max_new):
            host = tok[:, 0].tolist()
            for i in range(b):
                if step < batch[i].max_new_tokens:
                    outs[i].append(host[i])
            pos = torch.from_numpy(lens + step).to(dev)     # per-seq position
            logits, cache = self.model.decode_step(cache, tok, pos)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        for i, r in enumerate(batch):
            r.result = np.array(outs[i][: r.max_new_tokens], np.int32)
            r.done.set()
        return b

    def serve_forever(self):
        """Event-driven loop: sleep until a request arrives (no polling)."""
        while not self._stop:
            if self.requests.empty():
                try:
                    self.coord.wait("request_arrived", timeout=0.5)
                except TimeoutError:
                    continue
            self.run_once()

    def stop(self):
        self._stop = True
