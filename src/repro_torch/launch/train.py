"""Training entry point of the port: the train step, the fault-tolerant
loop and the CLI, the twin of the reference's ``repro/launch/train.py``
on one device.

    python -m repro_torch.launch.train --arch smollm-135m [--smoke]
        [--steps N] [--ckpt-dir D] [--device cpu]

``--arch`` names any architecture the port trains: the dense family
(smollm-135m, stablelm-3b, qwen2-7b, mistral-large-123b),
recurrentgemma-2b (``rglru`` and banded ``local`` layers),
whisper-large-v3 (the encoder-decoder: the pipeline draws its frames)
and phi-3-vision-4.2b (the VLM: the pipeline draws its patches).

``make_train_step`` builds one optimizer step over ``accum_steps``
microbatches (gradients summed in float32, then averaged, as the
reference's ``lax.scan`` does); ``run_training`` is the loop with
checkpoint / resume and a simulated crash (``crash_at``).  Both run on
the GPU unless the run asks for ``device="cpu"``.  The reference's mesh
path (``Policy``, sharded jit) is not ported: a ``mesh`` raises
(ROADMAP A9.6).  rwkv, MoE and MLA layers raise
``NotImplementedError`` (``models.transformer.check_trainable``, ROADMAP
A9.8c/d/e).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.sim import resolve_device
from repro_torch.data import SyntheticPipeline
from repro_torch.distributed import EventCoordinator
from repro_torch.models import Model, build
from repro_torch.tree import leaves, unflatten


def make_train_step(model: Model, opt_cfg: optim.AdamWConfig,
                    accum_steps: int = 1, grad_accum_dtype: str = "float32"):
    """``(opt_state, batch) -> (opt_state, metrics)``: one optimizer step
    of ``model`` (trainable: ``Model.train_mode``), its weights updated
    in place."""
    acc_dt = getattr(torch, grad_accum_dtype)
    params = model.params()
    weights = leaves(params)

    def grads_of(batch):
        for p in weights:
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        return [p.grad for p in weights], loss.detach(), \
            {k: v.detach() for k, v in metrics.items()}

    def train_step(opt_state, batch):
        if accum_steps == 1:
            grads, loss, metrics = grads_of(batch)
        else:
            micro = [{k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(accum_steps)]
            acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                   for p in weights]
            losses, ms = [], []
            for mb in micro:
                g, loss, m = grads_of(mb)
                acc = [a + gg.to(acc_dt) for a, gg in zip(acc, g)]
                losses.append(loss)
                ms.append(m)
            grads = [a / accum_steps for a in acc]
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        for p in weights:
            p.grad = None
        new_params, opt_state, opt_metrics = optim.update(
            opt_cfg, unflatten(params, iter(grads)), opt_state, params)
        with torch.no_grad():
            for p, n in zip(weights, leaves(new_params)):
                p.copy_(n)
        return opt_state, dict(metrics, **opt_metrics, loss=loss)

    return train_step


# ---------------------------------------------------------------------------
# Fault-tolerant training loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainRun:
    cfg: ModelConfig
    shape: ShapeSpec
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    mesh: Optional[Any] = None
    opt: optim.AdamWConfig = dataclasses.field(
        default_factory=optim.AdamWConfig)
    log_every: int = 10
    #: the run's device: the GPU unless "cpu"
    device: Optional[str] = None


def run_training(run: TrainRun, resume: bool = True,
                 crash_at: Optional[int] = None) -> Dict[str, Any]:
    """The end-to-end loop. ``crash_at`` simulates a mid-run failure for
    the fault-tolerance check: the step loop raises there, after the
    checkpoint in flight is on disk."""
    cfg = run.cfg
    if run.mesh is not None:
        raise NotImplementedError(
            "training on a mesh (the reference's Policy and sharded step) is "
            "not ported yet (ROADMAP A9.6); the port trains on one device")
    dev = resolve_device(run.device)
    model = build(cfg, dev).init(0).train_mode()
    opt_cfg = dataclasses.replace(
        run.opt, state_dtype=cfg.parallel.opt_state_dtype,
        total_steps=max(run.steps, 10))
    pipeline = SyntheticPipeline(cfg, run.shape, device=dev)
    coordinator = EventCoordinator()
    ckpt = Checkpointer(run.ckpt_dir, coordinator) if run.ckpt_dir else None

    opt_state = optim.init(opt_cfg, model.params())
    start_step = 0
    if ckpt is not None and resume:
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, {"params": model.params(),
                                          "opt": opt_state})
            model.load_params(state["params"])
            opt_state = state["opt"]
            start_step = latest
    step_fn = make_train_step(model, opt_cfg, cfg.parallel.accum_steps)

    metrics = {}
    t0 = time.time()
    for step in range(start_step, run.steps):
        if crash_at is not None and step == crash_at:
            if ckpt:
                ckpt.wait()
            raise RuntimeError(f"simulated failure at step {step}")
        batch = pipeline.batch(step)
        opt_state, metrics = step_fn(opt_state, batch)
        if ckpt is not None and (step + 1) % run.ckpt_every == 0:
            ckpt.save(step + 1, {"params": model.params(), "opt": opt_state})
        if (step + 1) % run.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            rate = (step + 1 - start_step) / (time.time() - t0)
            print(f"step {step+1:5d} loss={m['loss']:.4f} "
                  f"acc={m.get('acc', 0):.3f} gnorm={m['grad_norm']:.2f} "
                  f"({rate:.2f} it/s)")
    if ckpt is not None:
        ckpt.save(run.steps, {"params": model.params(), "opt": opt_state},
                  wait=True)
    out: Dict[str, Any] = {k: float(v) for k, v in metrics.items()}
    out["params"] = model.params()
    out["opt_state"] = opt_state
    return out


#: the caching allocator's setting for a training run: segments grow in
#: place, so the memory freed between steps is reused whatever the sizes
#: asked next (recurrentgemma-2b at 4 x 4 096 tokens, 73.3 GB at its peak
#: on an 80 GB H100, ran out of memory with fixed segments).  ``main`` sets
#: it unless the environment already does; a program that calls
#: ``run_training`` itself sets ``PYTORCH_CUDA_ALLOC_CONF`` before its
#: first CUDA allocation.
CUDA_ALLOC_CONF = "expandable_segments:True"


def main(argv=None):
    # before anything touches the card: the allocator reads it once
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", CUDA_ALLOC_CONF)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config + tiny shape")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)
    name = args.arch + ("-smoke" if args.smoke else "")
    cfg = get_config(name)
    shape = SHAPES[args.shape]
    if args.smoke:
        shape = ShapeSpec("smoke", 128, 4, "train")
    run = TrainRun(cfg=cfg, shape=shape, steps=args.steps,
                   ckpt_dir=args.ckpt_dir,
                   opt=optim.AdamWConfig(lr=args.lr), device=args.device)
    out = run_training(run)
    print({k: v for k, v in out.items() if isinstance(v, float)})


if __name__ == "__main__":
    main()
