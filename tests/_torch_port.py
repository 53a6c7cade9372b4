"""Helper of the tests/test_torch_*.py files: the port's modules (and with
them ``torch``) are imported when a test first touches them, not when the
test file is collected.

Every pytest-xdist worker collects — imports — every test file before it
runs anything. The JAX package's tests must go on running in processes that
hold exactly what they held before the port existed, so collecting the
port's tests may not pull ``torch`` into a worker.
"""

import importlib


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
            self._module = importlib.import_module(self._name)
        return self._module

    def __getattr__(self, attr):
        if attr.startswith("_"):
            raise AttributeError(attr)
        return getattr(self.load(), attr)
