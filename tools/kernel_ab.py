#!/usr/bin/env python3
"""Time this checkout's kernels against another checkout's on one card,
in turns.

    python3 tools/kernel_ab.py --base DIR            # flash, grouped_matmul
    python3 tools/kernel_ab.py --base DIR --engine   # the simulator

DIR is another checkout of this repository (for instance ``git archive
<commit>`` unpacked under ``build/``).  It needs a CUDA card and
``nvcc``.  Both modes print the card's ``nvidia-smi`` name and power
limit first and last.

Default mode: DIR's ``src/repro_torch/csrc/flash_attention.cu`` and
``grouped_matmul.cu`` are compiled with this checkout's ``nvcc`` flags
and bound through the same C interface as this checkout's own.  At each
serve shape (the bf16 shapes of ``chip_smoke.FLASH_HEAD``, ``FLASH_MOE``
and ``GMM_SERVE``, and the hd-256 shape in f32) the script times base,
this, this, base with ``chip_smoke.device_ms`` (device time per call,
``torch.profiler``) and checks both against the plain version within
``FLASH_TOL``/``GMM_TOL``.  It prints one JSON line per shape: both
builds' times (each the mean of its two turns, and the turns), the
bound and the PyTorch library call (``scaled_dot_product_attention``,
``torch.bmm``).

``--engine``: the five main-path points of ``chip_smoke``
(``FULL_WIDTH_POINTS``) at ``AB_ENGINE_CYCLES`` simulated cycles, run by
``tools/engine_points.py`` in a process of their own for each turn
(base, this, this, base), so each checkout runs its own engine: the
parent's per-cycle loop or this tree's one launch per run.  It prints
one JSON line per point: wall seconds and ms per simulated cycle of
both (mean of two turns, and the turns), core-cycles per second, the
ratio, whether the four runs' counters agree, and the barrier-only
calibration kernel's time per cycle at this tree's block size and
barriers per cycle (``chip_smoke.barrier_floor_ms``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.grouped_matmul import kernel as gm  # noqa: E402

#: (b, sq, skv, h, kv, hd, causal, dtype) of the flash shapes timed
FLASH = (cs.FLASH_MOE, cs.FLASH_HEAD, cs.FLASH_HEAD[:-1] + ("float32",))
#: simulated cycles of each --engine point: below the main path's
#: FULL_WIDTH_CYCLES because the per-cycle loop of a parent checkout
#: takes 8-11 s a point at 5 000 cycles on an H100 (1.6-2.1 ms a
#: cycle), and it runs twice at each of the five points
AB_ENGINE_CYCLES = 5_000


def build_base(base: Path, name: str):
    """``name``'s C entry point built from the checkout ``base``."""
    src = base / "src" / "repro_torch" / "csrc" / f"{name}.cu"
    out = ROOT / "build" / "kernel_ab" / f"lib{name}_base.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(name), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}:\n{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(out)), f"{name}_launch")
    return fn


def flash_call(fn, q, k, v, causal):
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
             k.shape[1], h, k.shape[2], hd, int(causal), hd ** -0.5,
             fa.DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch: CUDA error {err}")
    return out


def gmm_call(fn, x, w):
    e, c, d = x.shape
    out = torch.empty((e, c, w.shape[2]), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, w.shape[2],
             gm.DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"grouped_matmul launch: CUDA error {err}")
    return out


def turns(base_fn, this_fn, reps: int) -> dict:
    """base, this, this, base: each build's mean and its two turns."""
    t = [cs.device_ms(f, reps) for f in (base_fn, this_fn, this_fn, base_fn)]
    return dict(base_ms=(t[0] + t[3]) / 2, this_ms=(t[1] + t[2]) / 2,
                base_turns=(t[0], t[3]), this_turns=(t[1], t[2]))


def agrees(out, ref, tol) -> float:
    err = float((out.float() - ref.float()).abs().max())
    if not torch.allclose(out.float(), ref.float(), rtol=tol[0], atol=tol[1]):
        raise RuntimeError(f"differs from the plain version by {err}")
    return err


def engine_turn(root: Path) -> list:
    """One turn: ``tools/engine_points.py`` with the checkout ``root``."""
    pts = json.dumps([list(p) for p in cs.FULL_WIDTH_POINTS])
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "engine_points.py"),
         str(root), str(AB_ENGINE_CYCLES), pts], capture_output=True,
        text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"engine_points.py {root}:\n{proc.stderr}")
    return [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]


def engine_main(base: Path) -> None:
    """The simulator's points, base against this tree, in turns."""
    cycles = AB_ENGINE_CYCLES
    base_a, this_a, this_b, base_b = (
        engine_turn(r) for r in (base, ROOT, ROOT, base))
    for i, (name, n, bins) in enumerate(cs.FULL_WIDTH_POINTS):
        runs = (base_a[i], this_a[i], this_b[i], base_b[i])
        walls = [r["wall_s"] for r in runs]
        base_s, this_s = (walls[0] + walls[3]) / 2, (walls[1] + walls[2]) / 2
        threads, per_cycle = cs.run_block(name, n)
        floor = cs.barrier_floor_ms(threads, cycles, per_cycle)
        print(json.dumps(dict(
            kernel="engine_run", protocol=name, cores=n, bins=bins,
            cycles=cycles, base_wall_s=base_s, this_wall_s=this_s,
            base_turns=(walls[0], walls[3]), this_turns=(walls[1], walls[2]),
            base_ms_per_cycle=base_s / cycles * 1e3,
            this_ms_per_cycle=this_s / cycles * 1e3,
            base_core_cycles_per_s=n * cycles / base_s,
            this_core_cycles_per_s=n * cycles / this_s,
            speedup=base_s / this_s,
            counters_agree=all(r["summary"] == runs[0]["summary"]
                               for r in runs),
            threads=threads, barriers_per_cycle=per_cycle,
            barrier_floor_ms_per_cycle=floor / cycles)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, required=True,
                    help="root of the checkout to compare against")
    ap.add_argument("--engine", action="store_true",
                    help="time the simulator's main-path points instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    if args.engine:
        engine_main(args.base.resolve())
        print(cs.smi_line(), flush=True)
        return 0
    base_fa = build_base(args.base, "flash_attention")
    base_gm = build_base(args.base, "grouped_matmul")
    base_fa.argtypes = fa._launcher().argtypes
    base_gm.argtypes = gm._launcher().argtypes
    this_fa, this_gm = fa._launcher(), gm._launcher()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in FLASH:
        b, sq, skv, h, kv, hd, causal, dtype = shape
        q, k, v = cs.flash_inputs(dev, b, sq, skv, h, kv, hd, dtype, seed=5)
        ref = cs.flash_attention.flash_attention_ref(q, k, v, causal=causal)
        tol = cs.FLASH_TOL[dtype]
        errs = [agrees(flash_call(fn, q, k, v, causal), ref, tol)
                for fn in (base_fa, this_fa)]
        qs, ks, vs = (t.repeat_interleave(h // t.shape[2], dim=2)
                      .transpose(1, 2).contiguous() for t in (q, k, v))
        rec = dict(kernel="flash_attention", shape=shape,
                   **turns(lambda: flash_call(base_fa, q, k, v, causal),
                           lambda: flash_call(this_fa, q, k, v, causal), 20),
                   library_ms=cs.device_ms(
                       lambda: sdpa(qs, ks, vs, is_causal=causal), 20),
                   base_err=errs[0], this_err=errs[1],
                   **cs.flash_bound(*shape))
        print(json.dumps(rec), flush=True)
        del q, k, v, qs, ks, vs, ref
    for shape in cs.GMM_SERVE:
        x, w = cs.gmm_inputs(dev, *shape, "bfloat16", seed=5)
        ref = cs.gmm_plain(x, w)
        errs = [agrees(gmm_call(fn, x, w), ref, cs.GMM_TOL["bfloat16"])
                for fn in (base_gm, this_gm)]
        del ref
        rec = dict(kernel="grouped_matmul", shape=shape, dtype="bfloat16",
                   **turns(lambda: gmm_call(base_gm, x, w),
                           lambda: gmm_call(this_gm, x, w), 10),
                   library_ms=cs.device_ms(lambda: torch.bmm(x, w), 10),
                   base_err=errs[0], this_err=errs[1],
                   **cs.gmm_bound(*shape, "bfloat16"))
        print(json.dumps(rec), flush=True)
        del x, w
        torch.cuda.empty_cache()
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
