"""``engine_step_kernel``'s own source as the model checker's fused side,
on the CPU.

``src/repro_torch/csrc/engine_step.cu`` built with g++ against
``tests/cuda_cpu_mock.h`` (``tests/engine_mock.py``'s build) stands in
for ``fused_access`` in ``repro_torch.analysis.model_check``: each
distinct delivery is one call of the mock's ``engine_step_launch`` on the
one-candidate step (``model_check.stepped``), its bank state, kind and
per-core writes held to ``on_access`` under every rule of the checker.
The smallest configuration, ``Config(n=2, a=1, ops=1)``, is explored for
all eleven protocols, the kill pass included, in one child process (a
crash or a mock deadlock fails the cases, not the worker): 0 findings,
and states and transitions equal to the same exploration with
``fused_access``.  The card runs the full gate (``chip_smoke.py``'s
model_check phase).  Skips without g++.
"""
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from engine_mock import mock_library  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PROTOS = ("amo", "lrsc", "lrscwait", "colibri", "amo_lock", "lrsc_lock",
          "ticket_lock", "mwait_lock", "colibri_hier", "hw_event", "nb_feb")
CONFIG = dict(n=2, a=1, ops=1)


def explore(step=None) -> dict:
    """Every protocol at ``CONFIG`` with the fused side ``step`` (a
    ``fused_step``-shaped callable; None: ``fused_access``): states,
    transitions and rendered findings per protocol, and the fused side's
    calls (one per distinct delivery)."""
    from repro_torch.analysis import model_check as mc
    seam = mc.HookDriver.fused_side
    side = seam if step is None else mc.stepped(step, "cpu")
    calls = [0]

    def counted(kn, *args):
        calls[0] += 1
        return side(kn, *args)
    mc.HookDriver.fused_side = counted
    try:
        reps = [mc.check_protocol(name, kill=True,
                                  configs=[mc.Config(**CONFIG)])
                for name in PROTOS]
    finally:
        mc.HookDriver.fused_side = seam
    return dict(fused_calls=calls[0], protocols={
        r.subject: dict(states=r.stats["states"],
                        transitions=r.stats["transitions"],
                        findings=[f.render() for f in r.findings])
        for r in reps})


def mock_step(lib_path: str):
    """``kernel.step_launch`` bound to the mock build's entry point, and
    its call counter."""
    from repro_torch.kernels.engine_step import kernel as K
    launch = ctypes.CDLL(lib_path).engine_step_launch
    launch.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 16 \
        + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    calls = [0]

    def step(*args, **kw):
        calls[0] += 1
        return K.step_launch(launch, *args, **kw)
    return step, calls


@pytest.fixture(scope="module")
def explored(mock_library, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("model_check_mock") / "explored.json"
    proc = subprocess.run(
        [sys.executable, __file__, str(mock_library), str(out)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text()), explore()


@pytest.mark.parametrize("name", PROTOS)
def test_kernel_branch_passes_the_model_check(explored, name):
    card, plain = explored
    got, want = card["protocols"][name], plain["protocols"][name]
    assert got["findings"] == [], got["findings"]
    assert (got["states"], got["transitions"]) == (want["states"],
                                                   want["transitions"])
    assert want["states"] > 0


def test_every_delivery_launched_the_kernel_source(explored):
    card, plain = explored
    assert card["launches"] == card["fused_calls"] == plain["fused_calls"]
    assert card["launches"] >= len(PROTOS)


if __name__ == "__main__":
    # the child: the exploration with the mock build as the fused side
    step, calls = mock_step(sys.argv[1])
    res = explore(step)
    Path(sys.argv[2]).write_text(json.dumps(dict(res, launches=calls[0])))
