"""ONNX export (the port of ``paddle_tpu/onnx/__init__.py``; reference:
python/paddle/onnx/export.py over paddle2onnx).

As in the JAX package, the portable serving artifact is the program
``jit.save`` writes (here a ``torch.export`` program per input
signature, which ``jit.load`` and the inference predictors replay), and
``onnx.export`` writes that artifact at the requested path (without a
``.onnx`` suffix) and returns its prefix.  An ONNX emitter would add an
op-by-op converter matrix for no gain on the port's own paths;
consumers that need ``.onnx`` convert offline.
"""
from __future__ import annotations

__all__ = ["export"]


def export(layer, path, input_spec=None, opset_version=None, **configs):
    """paddle.onnx.export signature parity; emits the ``jit.save``
    artifact (see the module docstring).  Returns the artifact prefix."""
    from ..jit import save as jit_save

    if input_spec is None:
        raise ValueError(
            "onnx.export needs input_spec (example inputs) to trace the "
            "program — same requirement as the reference exporter")
    if path.endswith(".onnx"):
        path = path[:-5]
    jit_save(layer, path, example_inputs=list(input_spec))
    return path
