"""Helper of the tests/test_torch_*.py files: the port's modules (and with
them ``torch``) are imported when a test first touches them, not when the
test file is collected.

Every pytest-xdist worker collects — imports — every test file before it
runs anything. The JAX package's tests must go on running in processes that
hold exactly what they held before the port existed, so collecting the
port's tests may not pull ``torch`` into a worker.
"""

import importlib
import os

_threads_shared = False


def share_cores_among_workers() -> None:
    """Under pytest-xdist, give this worker's torch its share of the cores
    (cores // workers intra-op threads, at least one). Each worker's torch
    would otherwise start one thread a core, and six workers on eight cores
    spin 48 threads: a CPU proof that takes 8 s alone took 418 s with five
    others beside it, and 25-29 s with one thread a worker. Runs once a
    process, at the first import through lazy_module; outside xdist it
    changes nothing."""
    global _threads_shared
    if _threads_shared:
        return
    _threads_shared = True
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))


class lazy_module:
    """Stands for the module ``name``; imports it at the first access to one
    of its public attributes. Names with a leading underscore are refused
    without importing: pytest probes every module-level object for such
    names while it collects."""

    def __init__(self, name: str):
        self._name = name
        self._module = None

    def load(self):
        """The module itself (for its underscore-prefixed names)."""
        if self._module is None:
            share_cores_among_workers()
            self._module = importlib.import_module(self._name)
        return self._module

    def __getattr__(self, attr):
        if attr.startswith("_"):
            raise AttributeError(attr)
        return getattr(self.load(), attr)
