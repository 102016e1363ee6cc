#!/usr/bin/env python3
"""Time this checkout's kernels against another checkout's on one card,
in turns.

    python3 tools/kernel_ab.py --base DIR            # the four LM kernels
    python3 tools/kernel_ab.py --base DIR --only rglru,rwkv
    python3 tools/kernel_ab.py --base DIR --only scatter
    python3 tools/kernel_ab.py --base DIR --only flash_bwd
    python3 tools/kernel_ab.py --base DIR --engine   # the simulator

DIR is another checkout of this repository (for instance ``git archive
<commit>`` unpacked under ``build/``).  It needs a CUDA card and
``nvcc``.  Both modes print the card's ``nvidia-smi`` name and power
limit first and last.

Default mode: DIR's ``src/repro_torch/csrc/flash_attention.cu``,
``grouped_matmul.cu``, ``rglru_scan.cu`` and ``rwkv6_wkv.cu`` are
compiled with this checkout's ``nvcc`` flags and bound through their C
interfaces (``rglru_scan_launch`` through the one of DIR's own source:
``BASE_RGLRU_ARGS``, the PR 13 design's (a, x, h0, h, T, B*w, stream) on
contiguous inputs; the others through this checkout's).  At each serve
shape (the bf16 shapes of ``chip_smoke.FLASH_HEAD``, ``FLASH_MOE`` and
``GMM_SERVE``, the hd-256 shape in f32, ``RGLRU_HEAD`` and
``RWKV_HEAD``) the script times base, this, this, base with
``chip_smoke.device_ms`` (device time per call, ``torch.profiler``) and
checks both against the plain version within their ``chip_smoke``
tolerances.  It prints one JSON line per shape: both builds' times (each
the mean of its two turns, and the turns), the bound and the PyTorch
library call where there is one (``scaled_dot_product_attention``,
``torch.bmm``; none computes a linear recurrence).  The rglru row times
both builds on contiguous ``(T, B, w)`` inputs and this one also on the
model's ``(T, B, w)`` views of ``(B, T, w)`` tensors (``this_model_ms``;
the base design took those only through two ``.contiguous()`` copies,
which its row adds as ``base_copies_ms``).  ``--only`` picks the
kernels: ``flash``, ``gmm``, ``rglru``, ``rwkv``, ``scatter``.

``flash_bwd`` (not in the default set): DIR's
``flash_attention_bwd.cu`` against this tree's, both bound through this
tree's C signatures (the two entries have not changed), at
``FLASH_BWD_AB`` (train_b's shape and a bf16 hd-128 one), on the forward
kernel's o and lse: base, this, this, base, each call both launches.
Both builds' dq, dk and dv are held to the plain version within
``chip_smoke.FLASH_BWD_TOL`` (atol a fraction of each gradient's largest
magnitude).  Each row also holds both bounds (the gradient's five
products, ``bound_ms``, and the two-launch design's seven,
``bound7_ms``) and ``scaled_dot_product_attention``'s backward.

``scatter`` (not in the default set): DIR's ``colibri_scatter.cu``
against this tree's, on pre-sorted streams, at every
``chip_smoke.SCATTER_SHAPES`` shape (uniform keys), on the skewed stream
(``SCATTER_SKEW``) and on the trace streams of
``SCATTER_TRACE_TIMED`` (rebuilt from ``TRACE_REF``'s histograms, ones
as values).  DIR's ``colibri_commit_launch`` is bound with the C
signature of the one-block-per-bin design (``BASE_SCATTER_ARGS``: keys,
vals, out, T, d, bins, dtype, stream; this tree's takes a scratch and an
epoch besides).
Each row holds both builds' times, the byte bound and both builds'
worst difference from the plain version.

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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.grouped_matmul import kernel as gm  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as rg  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import kernel as rw  # noqa: E402

#: (b, sq, skv, h, kv, hd, causal, dtype) of the flash shapes timed
FLASH = (cs.FLASH_MOE, cs.FLASH_HEAD, cs.FLASH_HEAD[:-1] + ("float32",))
#: simulated cycles of each --engine point: below the main path's
#: FULL_WIDTH_CYCLES because the per-cycle loop of a parent checkout
#: takes 8-11 s a point at 5 000 cycles on an H100 (1.6-2.1 ms a
#: cycle), and it runs twice at each of the five points
AB_ENGINE_CYCLES = 5_000
#: the C signature of the base checkout's ``rglru_scan_launch`` (PR 13's
#: design): a, x, h0, h, T, B * w, stream
BASE_RGLRU_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 \
    + [ctypes.c_void_p]
#: the C signature of the one-block-per-bin design's
#: ``colibri_commit_launch``: keys, vals, out, T, d, bins, dtype, stream
BASE_SCATTER_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]
#: (b, sq, skv, h, kv, hd, causal, dtype) of ``--only flash_bwd``:
#: train_b's shape and a bf16 hd-128 one (16 query heads on 4, 2 048
#: tokens, causal)
FLASH_BWD_AB = (cs.FLASH_BWD_HEAD, (4, 2048, 2048, 16, 4, 128, True,
                                    "bfloat16"))
KERNELS = ("flash", "gmm", "rglru", "rwkv")
#: kinds --only also takes, outside the default set
EXTRA = ("scatter", "flash_bwd")


def base_library(base: Path, name: str) -> ctypes.CDLL:
    """``name``'s library built from the checkout ``base``."""
    src = base / "src" / "repro_torch" / "csrc" / f"{name}.cu"
    out = ROOT / "build" / "kernel_ab" / f"lib{name}_base.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(name), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def build_base(base: Path, name: str):
    """``name``'s C entry point built from the checkout ``base``."""
    return getattr(base_library(base, name), f"{name}_launch")


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


def base_rglru_call(fn, a, x, h0):
    t, b, w = a.shape
    out = torch.empty_like(a)
    err = fn(a.data_ptr(), x.data_ptr(), h0.data_ptr(), out.data_ptr(), t,
             b * w, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"base rglru_scan launch: CUDA error {err}")
    return out


def wkv_call(fn, r, k, v, w, u):
    b, t, h, hd = r.shape
    out = torch.empty_like(r)
    state = torch.empty((b, h, hd, hd), device=r.device)
    sb, st, sh, _ = rw._axis_strides(r)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), out.data_ptr(), state.data_ptr(), b, t, h, hd, sb,
             st, sh, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rwkv6_wkv launch: CUDA error {err}")
    return out, state


def rglru_rows(base: Path, dev) -> None:
    """The RG-LRU scan at ``RGLRU_HEAD``: base against this tree."""
    base_fn = build_base(base, "rglru_scan")
    base_fn.argtypes = BASE_RGLRU_ARGS
    base_fn.restype = ctypes.c_int
    shape = cs.RGLRU_HEAD
    t, b, w = shape
    a, x, h0 = cs.rglru_inputs(dev, *shape, seed=5)
    ref = cs.rglru_scan.rglru_scan_ref(a, x, h0)
    errs = [agrees(f(), ref, cs.RGLRU_TOL)
            for f in (lambda: base_rglru_call(base_fn, a, x, h0),
                      lambda: rg.rglru_scan_cuda(a, x, h0))]
    am, xm = (y.transpose(0, 1).contiguous().transpose(0, 1) for y in (a, x))
    errs.append(agrees(cs.rglru_scan.rglru_scan(am, xm, h0), ref,
                       cs.RGLRU_TOL))
    rec = dict(kernel="rglru_scan", shape=shape,
               **turns(lambda: base_rglru_call(base_fn, a, x, h0),
                       lambda: rg.rglru_scan_cuda(a, x, h0), 50),
               this_model_ms=cs.device_ms(
                   lambda: cs.rglru_scan.rglru_scan(am, xm, h0), 50),
               base_copies_ms=cs.device_ms(
                   lambda: (am.contiguous(), xm.contiguous()), 50),
               library_ms=None, base_err=errs[0], this_err=errs[1],
               this_model_err=errs[2], **cs.rglru_bound(*shape))
    print(json.dumps(rec), flush=True)


def rwkv_rows(base: Path, dev) -> None:
    """The WKV at ``RWKV_HEAD``, at the model's init decay: base against
    this tree."""
    base_fn = build_base(base, "rwkv6_wkv")
    base_fn.argtypes = rw._launcher().argtypes
    this_fn = rw._launcher()
    shape = cs.RWKV_HEAD
    ins = cs.rwkv_inputs(dev, *shape, cs.RWKV_DECAYS[0], seed=5)
    ref_out, ref_state = cs.rwkv6_wkv.wkv_ref(*ins)
    errs = []
    for fn in (base_fn, this_fn):
        out, state = wkv_call(fn, *ins)
        errs.append(max(agrees(out, ref_out, cs.RWKV_TOL),
                        agrees(state, ref_state, cs.RWKV_TOL)))
    rec = dict(kernel="rwkv6_wkv", shape=shape, decay=cs.RWKV_DECAYS[0],
               **turns(lambda: wkv_call(base_fn, *ins),
                       lambda: wkv_call(this_fn, *ins), 50),
               library_ms=None, base_err=errs[0], this_err=errs[1],
               **cs.rwkv_bound(*shape))
    print(json.dumps(rec), flush=True)


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
    ap.add_argument("--only", default=",".join(KERNELS),
                    help="comma-separated kernels: "
                         + ", ".join(KERNELS + EXTRA))
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(KERNELS + EXTRA):
        ap.error(f"--only takes {', '.join(KERNELS + EXTRA)}")
    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    if args.engine:
        engine_main(args.base.resolve())
        print(cs.smi_line(), flush=True)
        return 0
    if "flash" in only:
        flash_rows(args.base, dev)
    if "gmm" in only:
        gmm_rows(args.base, dev)
    if "rglru" in only:
        rglru_rows(args.base, dev)
    if "rwkv" in only:
        rwkv_rows(args.base, dev)
    if "scatter" in only:
        scatter_rows(args.base, dev)
    if "flash_bwd" in only:
        flash_bwd_rows(args.base, dev)
    print(cs.smi_line(), flush=True)
    return 0


def flash_rows(base: Path, dev) -> None:
    """flash_attention at its serve shapes: base against this tree."""
    base_fa = build_base(base, "flash_attention")
    base_fa.argtypes = fa._launcher().argtypes
    this_fa = fa._launcher()
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


def gmm_rows(base: Path, dev) -> None:
    """grouped_matmul at its serve shapes: base against this tree."""
    base_gm = build_base(base, "grouped_matmul")
    base_gm.argtypes = gm._launcher().argtypes
    this_gm = gm._launcher()
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


def base_scatter_call(base: Path, dev):
    """DIR's commit as ``f(sorted_keys, sorted_vals, bins) -> out``,
    bound with ``BASE_SCATTER_ARGS``."""
    fn = base_library(base, "colibri_scatter").colibri_commit_launch
    fn.argtypes = BASE_SCATTER_ARGS
    fn.restype = ctypes.c_int

    def call(sk, sv, bins):
        t, d = sv.shape
        out = torch.empty((bins, d), dtype=sv.dtype, device=dev)
        err = fn(sk.data_ptr(), sv.data_ptr(), out.data_ptr(), t, d, bins,
                 cs.cs_kernel.DTYPES[sv.dtype],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"base colibri_scatter: CUDA error {err}")
        return out
    return call


def scatter_rows(base: Path, dev) -> None:
    """The commit kernel on sorted streams: base against this tree."""
    base_fn = base_scatter_call(base, dev)
    this_fn = cs.cs_kernel.scatter_commit_cuda
    cases = []
    for shape in cs.SCATTER_SHAPES:
        keys, vals = cs.scatter_inputs(dev, *shape, seed=sum(shape[:3]))
        cases.append(("uniform", shape, keys, vals))
    t, bins = cs.SCATTER_SKEW
    g = torch.Generator(device=dev).manual_seed(41)
    cases.append(("skewed", (t, bins, 1, "float32"),
                  torch.from_numpy(cs.skewed_keys(t, bins, seed=41)).to(dev),
                  torch.randn((t, 1), generator=g, device=dev)))
    for point in cs.SCATTER_TRACE_TIMED:
        hist = cs.TRACE_REF[point]["trace_latency_hist"]
        keys = torch.from_numpy(np.repeat(np.arange(len(hist), dtype=np.int32),
                                          hist)).to(dev)
        cases.append((point, (keys.numel(), len(hist), 1, "float32"), keys,
                      torch.ones((keys.numel(), 1), device=dev)))
    for name, (t, bins, d, dtype), keys, vals in cases:
        order = torch.argsort(keys, stable=True)
        sk, sv = keys[order].contiguous(), vals[order].contiguous()
        ref = cs.colibri_scatter.scatter_add_ref(sk, sv, bins)
        tol = cs.SCATTER_TOL[dtype]
        errs = [agrees(f(sk, sv, bins), ref, tol) for f in (base_fn, this_fn)]
        reps = 20 if t * d >= 1 << 20 else 100
        rec = dict(kernel="colibri_scatter", keys=name, shape=(t, bins, d, dtype),
                   **turns(lambda: base_fn(sk, sv, bins),
                           lambda: this_fn(sk, sv, bins), reps),
                   base_err=errs[0], this_err=errs[1],
                   **cs.scatter_bound(t, bins, d, sv.element_size()))
        print(json.dumps(rec), flush=True)



def bwd_call(fns, q, k, v, o, do, lse, causal):
    """The two backward launches through ``fns`` (dq, dk/dv entries):
    (dq, dk, dv)."""
    dq_fn, dkdv_fn = fns
    b, sq, h, hd = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    dims = (b, sq, k.shape[1], h, k.shape[2], hd, int(causal), hd ** -0.5,
            fa.DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    for err in (dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), dq.data_ptr(), *dims),
                dkdv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), *dims)):
        if err:
            raise RuntimeError(f"flash_attention_bwd launch: CUDA error {err}")
    return dq, dk, dv


def bwd_agrees(got, want, dtype) -> float:
    """The largest |difference| of dq, dk, dv from the plain version's,
    each within ``FLASH_BWD_TOL`` (atol times its largest magnitude)."""
    rtol, atol = cs.FLASH_BWD_TOL[dtype]
    worst = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        gf, wf = g.float(), w.float()
        err = float((gf - wf).abs().max())
        if not torch.allclose(gf, wf, rtol=rtol,
                              atol=atol * float(wf.abs().max())):
            raise RuntimeError(f"{name} differs from the plain version by "
                               f"{err}")
        worst = max(worst, err)
    return worst


def flash_bwd_rows(base: Path, dev) -> None:
    """The flash-attention backward at ``FLASH_BWD_AB``: base against
    this tree."""
    lib = base_library(base, "flash_attention_bwd")
    this_fns = fa._bwd_launchers()
    base_fns = (lib.flash_attention_bwd_dq_launch,
                lib.flash_attention_bwd_dkdv_launch)
    for fn, ref in zip(base_fns, this_fns):
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    for shape in FLASH_BWD_AB:
        b, sq, skv, h, kv, hd, causal, dtype = shape
        q, k, v = cs.flash_inputs(dev, b, sq, skv, h, kv, hd, dtype, seed=5)
        do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                         .manual_seed(6), device=dev).to(q.dtype)
        o, lse = fa.flash_attention_fwd_lse_cuda(q, k, v, causal=causal)
        want = cs.flash_attention.flash_attention_bwd_ref(q, k, v, o, do,
                                                          lse, causal=causal)
        errs = [bwd_agrees(bwd_call(fns, q, k, v, o, do, lse, causal), want,
                           dtype) for fns in (base_fns, this_fns)]
        del want
        torch.cuda.empty_cache()
        rec = dict(kernel="flash_attention_bwd", shape=shape,
                   **turns(lambda: bwd_call(base_fns, q, k, v, o, do, lse,
                                            causal),
                           lambda: bwd_call(this_fns, q, k, v, o, do, lse,
                                            causal), 10),
                   base_err=errs[0], this_err=errs[1],
                   **cs.flash_bwd_bound(*shape))
        rec["speedup"] = rec["base_ms"] / rec["this_ms"]
        rec["library_fwd_ms"], rec["library_ms"] = cs.sdpa_ms(q, k, v, do,
                                                              causal)
        print(json.dumps(rec), flush=True)
        del q, k, v, o, do, lse
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
