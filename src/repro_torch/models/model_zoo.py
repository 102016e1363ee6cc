"""Unified model API of the port: ``build(cfg)`` → ``Model``, an
``nn.Module`` with the entry points of the reference's
``repro/models/model_zoo.py``: serving (``init``, ``init_cache``,
``prefill``, ``decode_step``, ``logits``) and training (``hidden``,
``loss``, after ``train_mode()`` hands out trainable parameters; the
dense family only, ``transformer.check_trainable``).

The model lives on one device, chosen when it is built: the GPU unless
the caller passes ``device="cpu"`` (``repro_torch.core.sim.
resolve_device``: without a GPU, the default raises).  ``build``
allocates the weights uninitialised; ``init(seed)`` draws them in place
from a ``torch.Generator`` on that device, ``load_params`` copies given
ones in (``repro_torch.convert.model_from_jax`` loads the reference's).
Neither allocates a second copy of the weights: a model as large as
half the card (kimi-k2-1t-a32b's MoE layer) seeds and loads in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sim import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.tree import leaves

Params = TF.Params


class Model(nn.Module):
    """The decoder-only LM: embedding, one ``TF.Block`` per layer in
    ``blocks``, final norm and (untied) ``lm_head``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        params = TF.init_params(cfg, None, resolve_device(device))
        self.top = TF.ParamTree({k: v for k, v in params.items()
                                 if k != "layers"})
        self.blocks = nn.ModuleList(
            TF.Block(sig, lp)
            for sig, lp in zip(TF.layer_sigs(cfg), params["layers"]))

    @property
    def device(self) -> torch.device:
        return self.top.embed.device

    # ---- weights ----
    def params(self) -> Params:
        """The weights as the reference's tree, unstacked: ``{"embed",
        "final_norm", ["lm_head"], "layers": [one dict per layer]}``."""
        return dict(self.top.tree(), layers=[b.params() for b in self.blocks])

    @torch.no_grad()
    def load_params(self, tree: Params) -> "Model":
        """Copy ``tree`` (the layout of ``params()``) into the weights,
        in place, each leaf cast to its parameter's dtype and moved to
        the model's device; shapes must match."""
        own = self.params()

        def load(mine, theirs, path):
            if isinstance(mine, torch.Tensor):
                if tuple(theirs.shape) != tuple(mine.shape):
                    raise ValueError(f"{path}: shape {tuple(theirs.shape)}, "
                                     f"the model has {tuple(mine.shape)}")
                mine.copy_(theirs)
                return
            if isinstance(mine, list):
                if len(theirs) != len(mine):
                    raise ValueError(f"{path}: {len(theirs)} entries, the "
                                     f"model has {len(mine)}")
                for i, (m, t) in enumerate(zip(mine, theirs)):
                    load(m, t, f"{path}[{i}]")
                return
            if set(theirs) != set(mine):
                raise ValueError(f"{path}: keys {sorted(theirs)}, the model "
                                 f"has {sorted(mine)}")
            for k in mine:
                load(mine[k], theirs[k], f"{path}.{k}" if path else k)
        load(own, tree, "")
        return self

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Model":
        """Draw the weights in place from ``torch.Generator(device).
        manual_seed(seed)``, with the reference's initialisers, one leaf
        at a time (a large leaf ``L.DRAW_CHUNK`` elements at a time)."""
        draw = L.Draw(torch.Generator(device=self.device).manual_seed(seed),
                      leaves(self.params()))
        TF.init_params(self.cfg, draw, self.device)
        draw.done()
        return self

    # ---- training ----
    def train_mode(self, on: bool = True) -> "Model":
        """Hand out the weights trainable (``requires_grad``), or frozen
        again for serving.  Training refuses what the port cannot
        differentiate (``transformer.check_trainable``)."""
        if on:
            TF.check_trainable(self.cfg)
        self.requires_grad_(on)
        return self

    def hidden(self, batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch ``{"tokens": (B,S)}`` -> (hidden (B,S,d), aux loss)."""
        return TF.forward(self.cfg, self.params(), batch["tokens"])

    def loss(self, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch ``{"tokens", "labels"}`` (labels -1 masked) -> (loss,
        {"loss", "acc", "aux"}): the mean token cross entropy with the
        reference's z-loss, over chunked logits."""
        h, aux = self.hidden(batch)
        loss, acc = TF.loss_fn(self.cfg, self.params(), h, batch["labels"])
        return loss, {"loss": loss, "acc": acc, "aux": aux}

    # ---- serving ----
    def init_cache(self, batch: int, seq: int) -> List[Params]:
        """An empty decode cache of ``seq`` positions for ``batch``
        sequences, one dict per layer, in the compute dtype."""
        return TF.init_cache(self.cfg, batch, seq, self.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: int):
        """tokens (B,S) int -> (hidden (B,S,d), cache of ``cache_len``)."""
        return TF.prefill(self.cfg, self.params(), tokens,
                          self.init_cache(tokens.shape[0], cache_len))

    @torch.no_grad()
    def decode_step(self, cache: List[Params], tokens: torch.Tensor,
                    pos: torch.Tensor):
        """tokens (B,1), pos (B,) -> (logits (B,1,V) float32, cache)."""
        return TF.decode_step(self.cfg, self.params(), cache, tokens, pos)

    @torch.no_grad()
    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return TF.logits(self.cfg, self.top.tree(), hidden)


def build(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (the GPU by default), weights
    allocated but not drawn: call ``init(seed)`` or ``load_params``."""
    return Model(cfg, device)
