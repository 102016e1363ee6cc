"""repro_torch.core — the engine layer of the port.

* ``sim``        — the cycle-level manycore engine.
* ``protocols``  — registry of synchronization protocol plugins.
* ``workloads``  — registry of per-core programs.
* ``topologies`` — registry of NoC shapes.
* ``metrics``    — single derivation layer for the paper's metric triple.
* ``costmodel``  — area/energy models calibrated to Tables I–II.
* ``colibri``    — message-level protocol model (correctness: Section IV-A).
"""
from repro_torch.core import colibri

__all__ = ["colibri"]
