"""slimt_jax — a quantized machine-translation inference engine on JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
jerinphilip/slimt (the Bergamot/Marian "tiny student" inference frontend):
INT8 weight-quantized transformer encoder + SSRU decoder models, lexical
shortlists, sentencepiece tokenization, sentence splitting, request
batching, HTML passthrough, pivot translation — on one backend-neutral XLA path.

Public surface (mirrors the reference umbrella header slimt/slimt.hh:1-5):

    from slimt_jax import Model, Package, Blocking, Async, Config
"""

__version__ = "0.1.0"

from slimt_jax.config import Config, ModelConfig, preset  # noqa: F401

_LAZY = {
    "Model": ("slimt_jax.models.model", "Model"),
    "Package": ("slimt_jax.models.model", "Package"),
    "Blocking": ("slimt_jax.runtime.service", "Blocking"),
    "Async": ("slimt_jax.runtime.service", "Async"),
    "Response": ("slimt_jax.runtime.response", "Response"),
}


def __getattr__(name):
    # Lazy imports keep `import slimt_jax` light (no JAX load for
    # IO/text-only users) and avoid import cycles.
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(name)
