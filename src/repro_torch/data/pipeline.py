"""Deterministic synthetic token pipeline: the twin of the reference's
``repro/data/pipeline.py``.

Determinism is a fault-tolerance feature: batch(step) is a pure function of
(seed, step), so any worker can recompute any microbatch after a restart
-- no data-loader state to checkpoint.  The draw is the reference's own
(numpy's Philox keyed by seed + step, then a search of the skewed
unigram table), so both packages see the same tokens; the batch is then
moved to the pipeline's device (the GPU unless ``device="cpu"``).  The
encoder-decoder's batch also holds ``encoder_feats`` (B, Se, d) and the
VLM's ``patch_embeds`` (B, P, d): normals times 0.02 drawn from the same
generator after the tokens, in the config's compute dtype, the
reference's bits.

The token statistics go through the colibri ordered commit
(``kernels.colibri_scatter.colibri_histogram``: the commit kernel on the
card, its plain version on the CPU), the data-path instance of the
paper's retry-free scatter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.sim import resolve_device
from repro_torch.kernels.colibri_scatter import colibri_histogram


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    # zipf-ish unigram skew for realistic vocab statistics
    skew: float = 1.2


class SyntheticPipeline:
    """Markov-ish synthetic LM data with a skewed unigram distribution."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 data_cfg: DataConfig = DataConfig(), device=None):
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        # precompute a skewed unigram table (host, numpy)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-data_cfg.skew)
        self.cum = np.cumsum(probs / probs.sum())

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Pure function of (seed, step) -- recomputable anywhere."""
        b, s = self.shape.global_batch, self.shape.seq_len
        rng = np.random.Generator(np.random.Philox(
            key=self.data_cfg.seed + step))
        u = rng.random((b, s))
        tokens = np.searchsorted(self.cum, u).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1                       # mask final position
        out = {"tokens": tokens, "labels": labels}
        cdt = getattr(torch, self.cfg.compute_dtype)
        if self.cfg.frontend == "audio":
            feats = rng.standard_normal(
                (b, self.cfg.encoder.seq_len, self.cfg.d_model)) * 0.02
            out["encoder_feats"] = torch.from_numpy(feats).to(cdt)
        if self.cfg.frontend == "vlm":
            out["patch_embeds"] = torch.from_numpy(rng.standard_normal(
                (b, self.cfg.num_patches, self.cfg.d_model)) * 0.02).to(cdt)
        return {k: torch.as_tensor(v).to(self.device) for k, v in out.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    def token_histogram(self, batch: Dict[str, torch.Tensor],
                        num_bins: int = 256) -> torch.Tensor:
        """Vocab-bucket histogram via the colibri ordered commit -- the
        data-path instance of the paper's retry-free scatter."""
        keys = (batch["tokens"].reshape(-1) % num_bins).to(torch.int32)
        return colibri_histogram(keys, num_bins)
