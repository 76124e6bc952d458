"""The package's former import name, kept so that code written against
it goes on working. Importing this package, or any module under it,
gives the very module objects of `slimt_jax` (one copy of every class
and of every jit cache), with a DeprecationWarning."""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

_NEW = "slimt_jax"


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """`<this package>.x.y` resolves to `slimt_jax.x.y`."""

    def __init__(self):
        self._specs = {}

    def find_spec(self, name, path=None, target=None):
        if name.startswith(__name__ + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(__name__):])
        self._specs[spec.name] = module.__spec__
        return module

    def exec_module(self, module):
        # The import system set __spec__ to the alias's; give the module
        # its own back.
        module.__spec__ = self._specs.pop(module.__spec__.name)


warnings.warn(
    f"the package {__name__!r} is now {_NEW!r}; import {_NEW}",
    DeprecationWarning,
    stacklevel=2,
)
sys.meta_path.insert(0, _Alias())
sys.modules[__name__] = importlib.import_module(_NEW)
