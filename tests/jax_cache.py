"""Release the XLA executables a test module compiled when it ends.

Each jitted configuration of the reference (``repro``) keeps its compiled
code mapped in the process, a few hundred memory mappings each, and a
pytest worker that runs many such modules can reach the kernel's limit
on mappings per process (``vm.max_map_count``), where XLA's next compile
crashes the worker.  Port test modules that run the reference import
``release_compiled``, an autouse fixture that clears JAX's caches when
the module's last test has run.
"""
import gc

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def release_compiled():
    yield
    jax.clear_caches()
    gc.collect()
