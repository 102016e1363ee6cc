"""Unified model API of the port: ``build(cfg)`` → ``Model``, an
``nn.Module`` with the entry points of the reference's
``repro/models/model_zoo.py``: serving (``init``, ``init_cache``,
``prefill``, ``decode_step``, ``logits``) and training (``hidden``,
``loss``, after ``train_mode()`` hands out trainable parameters; every
architecture but rwkv, MoE and MLA, ``transformer.check_trainable``).  A
config with an encoder builds the encoder-decoder (``encdec``); the
others the decoder-only LM (``transformer``).  ``prefill`` and ``hidden`` take the
inputs of the reference's batch beside the tokens: ``encoder_feats`` for
the encoder-decoder, ``patch_embeds`` for the VLM.

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
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.tree import leaves

Params = TF.Params


#: the encoder-decoder's layer signatures (``TF.Block.sig``)
ENC_SIG, DEC_SIG = ("enc", "mlp"), ("dec", "mlp")
#: the inputs of the reference's batch that a frontend takes
FRONTEND = ("encoder_feats", "patch_embeds")


class Model(nn.Module):
    """The decoder-only LM: embedding, one ``TF.Block`` per layer in
    ``blocks``, final norm and (untied) ``lm_head``.  The encoder-decoder
    (``cfg.encoder`` set) also holds the frames' ``pos_embed``, one block
    per encoder layer in ``enc_blocks`` and the ``enc_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        encdec = cfg.encoder is not None
        # the module of the architecture's init, cache and decode step
        self._impl = ED if encdec else TF
        params = self._impl.init_params(cfg, None, resolve_device(device))
        self.top = TF.ParamTree({k: v for k, v in params.items()
                                 if k not in ("layers", "enc_layers")})
        self.enc_blocks = nn.ModuleList(
            TF.Block(ENC_SIG, lp) for lp in params.get("enc_layers", []))
        sigs = [DEC_SIG] * cfg.num_layers if encdec else TF.layer_sigs(cfg)
        self.blocks = nn.ModuleList(
            TF.Block(sig, lp) for sig, lp in zip(sigs, params["layers"]))

    @property
    def device(self) -> torch.device:
        return self.top.embed.device

    # ---- weights ----
    def params(self) -> Params:
        """The weights as the reference's tree, unstacked: ``{"embed",
        "final_norm", ["lm_head"], "layers": [one dict per layer]}``; the
        encoder-decoder's ``{"pos_embed", "enc_norm", "embed",
        "final_norm", "enc_layers": [...], "layers": [...]}``."""
        out = self.top.tree()
        if self.cfg.encoder is not None:
            out["enc_layers"] = [b.params() for b in self.enc_blocks]
        out["layers"] = [b.params() for b in self.blocks]
        return out

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
        self._impl.init_params(self.cfg, draw, self.device)
        draw.done()
        return self

    def _frontend(self, given: Dict[str, Any]) -> Dict[str, Any]:
        """The frontend inputs of ``given`` that are not None; raises
        ValueError on one the architecture does not take, or when the
        encoder-decoder lacks its ``encoder_feats``."""
        given = {k: v for k, v in given.items() if v is not None}
        takes = {"audio": "encoder_feats", "vlm": "patch_embeds"}.get(
            self.cfg.frontend)
        extra = sorted(set(given) - {takes})
        if extra:
            raise ValueError(f"{self.cfg.name} takes no {extra}")
        if self.cfg.encoder is not None and takes not in given:
            raise ValueError(f"{self.cfg.name} needs {takes}")
        return given

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
        """batch ``{"tokens": (B,S)}`` (with ``"encoder_feats"`` (B,Se,d)
        for the encoder-decoder, optionally ``"patch_embeds"`` (B,P,d) for
        the VLM) -> (hidden (B,S,d), aux loss)."""
        frontend = self._frontend({k: batch.get(k) for k in FRONTEND})
        return self._impl.forward(self.cfg, self.params(), batch["tokens"],
                                  **frontend)

    def loss(self, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch ``{"tokens", "labels"}`` (labels -1 masked; with the
        frontend's input as ``hidden`` takes it) -> (loss, {"loss", "acc",
        "aux"}): the mean token cross entropy with the reference's z-loss,
        over chunked logits."""
        h, aux = self.hidden(batch)
        loss, acc = TF.loss_fn(self.cfg, self.params(), h, batch["labels"])
        return loss, {"loss": loss, "acc": acc, "aux": aux}

    # ---- serving ----
    def init_cache(self, batch: int, seq: int) -> List[Params]:
        """An empty decode cache of ``seq`` positions for ``batch``
        sequences, one dict per layer, in the compute dtype (the
        encoder-decoder's also holds each layer's cross K/V)."""
        return self._impl.init_cache(self.cfg, batch, seq, self.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: int,
                **frontend: torch.Tensor):
        """tokens (B,S) int -> (hidden (B,S,d), cache of ``cache_len``);
        the encoder-decoder needs ``encoder_feats`` (B,Se,d), the VLM
        takes ``patch_embeds`` (B,P,d) over its first positions."""
        cache = self.init_cache(tokens.shape[0], cache_len)
        return self._impl.prefill(self.cfg, self.params(), tokens, cache,
                                  **self._frontend(frontend))

    @torch.no_grad()
    def decode_step(self, cache: List[Params], tokens: torch.Tensor,
                    pos: torch.Tensor):
        """tokens (B,1), pos (B,) -> (logits (B,1,V) float32, cache)."""
        return self._impl.decode_step(self.cfg, self.params(), cache, tokens,
                                      pos)

    @torch.no_grad()
    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return TF.logits(self.cfg, self.top.tree(), hidden)


def build(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (the GPU by default), weights
    allocated but not drawn: call ``init(seed)`` or ``load_params``."""
    return Model(cfg, device)
