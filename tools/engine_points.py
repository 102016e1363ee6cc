#!/usr/bin/env python3
"""Time the simulator's points with one checkout's ``repro_torch`` on the
card.

    python3 tools/engine_points.py ROOT CYCLES POINTS

ROOT is a checkout of this repository, CYCLES the simulated cycles of
every point and POINTS a JSON list of ``[protocol, cores, bins]`` (the
Fig. 3 histogram at ``zipf_skew=0``, ``SimParams`` defaults otherwise).
After one warm run (CUDA start-up and the kernels' build), each point
runs once through ``repro_torch.sync.run`` on the card and prints one
JSON line: its wall seconds (host clock; ``run`` returns numpy
results, so the card has finished), ms per simulated cycle,
core-cycles per second and the summary counters, which two checkouts
must agree on.  ``tools/kernel_ab.py --engine`` runs it for two
checkouts in turns.
"""
import json
import sys
import time
from pathlib import Path

ROOT, CYCLES, POINTS = Path(sys.argv[1]), int(sys.argv[2]), \
    json.loads(sys.argv[3])
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

from repro_torch.sync import Spec, run  # noqa: E402

run(Spec(protocol="colibri", n_cores=64, cycles=50))             # warm
for name, n, bins in POINTS:
    spec = Spec(protocol=name, workload="zipf_histogram", zipf_skew=0,
                n_cores=n, n_addrs=bins, cycles=CYCLES)
    t0 = time.perf_counter()
    r = run(spec)
    wall = time.perf_counter() - t0
    print(json.dumps(dict(
        protocol=name, cores=n, bins=bins, cycles=CYCLES, wall_s=wall,
        ms_per_cycle=wall / CYCLES * 1e3,
        core_cycles_per_s=n * CYCLES / wall,
        summary={k: int(np.asarray(r.stats[k]).sum()) for k in (
            "ops", "msgs", "polls", "sleep_cyc", "backoff_cyc",
            "bank_ops", "net_stall", "lat_max")})), flush=True)
