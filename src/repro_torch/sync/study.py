"""``Study`` — a declarative multi-point experiment over the sweep engine
(port of ``repro.sync.study``).

A study is a base :class:`~repro_torch.sync.Spec` plus a chain of axis
*blocks*::

    Study(Spec(workload="zipf_histogram", zipf_skew=0)) \\
        .grid(lat=[1, 4, 16], n_cores=[8, 64, 256]) \\
        .zip(seed=range(4))

``grid`` multiplies the current point set by the cartesian product of
its axes (last axis fastest, like the legacy ``sweep_grid``); ``zip``
multiplies by equal-length axes varied in lockstep.  Axis names are any
flat Spec field — *including* ``protocol``/``workload`` names and
``n_cores`` (the sweep runner puts every point of one core count into
one launch of the engine kernel).  Irregular point sets (figure
benchmarks with special-cased lines) skip the builder:
:meth:`Study.from_specs` takes an explicit spec list, of specs or of
spec dicts (the reference's ``Spec.to_dict()`` too).  A point the card's
kernel does not take (``engine_step.kernel.refuse_on_card``: a program
of more than ``MAX_STEPS`` steps, too deep a topology) raises
``NotImplementedError`` from ``run``/``stream`` on the card while the
grid is planned, before any launch; the plain loop (``device="cpu"``)
runs it.

Execution runs the point list through the batched sweep
(``repro_torch.core.sweep``) on ``device`` (default the GPU; pass
``device="cpu"`` for the plain loop):

* :meth:`run` — all points, as a list of typed
  :class:`~repro_torch.sync.Result`, in point order;
* :meth:`stream` — a generator yielding each ``Result`` as its sweep
  chunk materializes (chunk-completion order, NOT point order — each
  result's ``.spec`` identifies it), so figure scripts consume early
  points while later chunks are still in flight.

Studies are immutable: ``grid``/``zip`` return extended copies, so a
partial study can be shared and forked.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

from repro_torch.core import sweep as _sweep
from repro_torch.sync.result import Result
from repro_torch.sync.spec import Spec


def _as_spec(base: Any, flat: Dict[str, Any]) -> Spec:
    if base is None:
        return Spec(**flat)
    if isinstance(base, dict):
        base = Spec.from_dict(base)
    if not isinstance(base, Spec):
        raise ValueError(f"Study base must be a Spec, a dict of Spec "
                         f"fields, or None (got {base!r})")
    return base.replace(**flat) if flat else base


class Study:
    """Declarative experiment: base spec × axis blocks.  See the module
    docstring; construct as ``Study(spec)``, ``Study(protocol="lrsc",
    n_cores=64)`` (flat Spec fields), or :meth:`Study.from_specs`."""

    def __init__(self, base: Any = None, **flat: Any):
        self._bases: List[Spec] = [_as_spec(base, flat)]
        self._blocks: List[List[Dict[str, Any]]] = []

    @classmethod
    def from_specs(cls, specs: Iterable[Any]) -> "Study":
        """A study over an explicit point list (specs or spec-dicts).
        ``grid``/``zip`` still compose: each axis block multiplies every
        listed point."""
        self = cls.__new__(cls)
        self._bases = [s if isinstance(s, Spec) else Spec.from_dict(s)
                       for s in specs]
        if not self._bases:
            raise ValueError("Study.from_specs needs at least one spec")
        self._blocks = []
        return self

    # ---- builders (immutable: each returns an extended copy) ------------
    def _extend(self, blocks: List[List[Dict[str, Any]]]) -> "Study":
        out = Study.__new__(Study)
        out._bases = self._bases
        out._blocks = self._blocks + blocks
        return out

    def grid(self, **axes: Sequence[Any]) -> "Study":
        """Multiply the point set by the cartesian product of ``axes``
        (last axis fastest).  Values are flat Spec field values;
        ``protocol=``/``workload=`` take name strings."""
        if not axes:
            return self
        mat = {name: list(vals) for name, vals in axes.items()}
        for name, vals in mat.items():
            if not vals:
                raise ValueError(f"grid axis {name!r} is empty")
        return self._extend([[{name: v} for v in vals]
                             for name, vals in mat.items()])

    def zip(self, **axes: Sequence[Any]) -> "Study":
        """Multiply the point set by equal-length axes varied in
        lockstep (one point per position, not a product)."""
        if not axes:
            return self
        names = list(axes)
        cols = [list(axes[n]) for n in names]
        lengths = {n: len(c) for n, c in zip(names, cols)}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"zip axes must have equal lengths, got "
                             f"{lengths}")
        if lengths[names[0]] == 0:
            raise ValueError("zip axes are empty")
        return self._extend([[dict(zip(names, vals))
                              for vals in zip(*cols)]])

    # ---- the compiled point list ----------------------------------------
    def specs(self) -> List[Spec]:
        """Every point of the study, in order (bases outermost, then
        each axis block, last block fastest)."""
        overrides: List[Dict[str, Any]] = [{}]
        for block in self._blocks:
            overrides = [{**o, **delta} for o in overrides
                         for delta in block]
        return [base.replace(**o) if o else base
                for base in self._bases for o in overrides]

    def __len__(self) -> int:
        n = len(self._bases)
        for block in self._blocks:
            n *= len(block)
        return n

    # ---- execution ------------------------------------------------------
    def run(self, max_batch: Optional[int] = None, energy_fit=None,
            report=None, device=None) -> List[Result]:
        """All points through the batched sweep on ``device``; one typed
        :class:`Result` per point, in :meth:`specs` order.

        ``report`` (a :class:`repro_torch.obs.RunReport`) collects
        per-chunk instrumentation; an enclosing
        ``repro_torch.obs.collect()`` block works too."""
        specs = self.specs()
        raw = _sweep.sweep_params([s.to_params() for s in specs],
                                  max_batch=max_batch,
                                  energy_fit=energy_fit, report=report,
                                  device=device)
        return [Result(spec=s, stats=r) for s, r in zip(specs, raw)]

    def stream(self, max_batch: Optional[int] = None, energy_fit=None,
               report=None, device=None) -> Iterator[Result]:
        """Yield each point's :class:`Result` as its sweep chunk
        materializes (chunk-completion order; ``result.spec`` identifies
        the point).  Same results as :meth:`run`, different order.
        ``report`` instruments like :meth:`run`."""
        specs = self.specs()
        for i, r in _sweep.sweep_iter([s.to_params() for s in specs],
                                      max_batch=max_batch,
                                      energy_fit=energy_fit,
                                      report=report, device=device):
            yield Result(spec=specs[i], stats=r)
