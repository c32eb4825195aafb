"""Autocast (the port of ``paddle_tpu/amp/auto_cast.py``).

A thread-local mode read by the port's op registry on entry to every op
(``core/dispatch.py`` calls ``_cast_args``).  It follows the JAX package's lists, not ``torch.autocast``'s:
the positional float tensor arguments of a white-listed op are cast to the
AMP dtype, those of a black-listed op that are in the AMP dtype are cast
up to fp32, and every other op runs in the dtypes it is given.  So under
O1 a ResNet's convolutions run bf16 and its batch norms hand fp32 onward,
where ``torch.autocast`` would keep the activations bf16 (a different
function).  O2 is ``decorate``: the parameters themselves are cast."""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core.dtype import convert_dtype

__all__ = ["WHITE_LIST", "BLACK_LIST", "white_list", "auto_cast",
           "amp_guard", "decorate", "is_enabled", "maybe_cast_inputs"]

WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "scaled_dot_product_attention",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "softmax",
    "log_softmax", "cross_entropy", "softmax_with_cross_entropy", "mean",
    "sum", "cumsum", "layer_norm", "batch_norm_train", "batch_norm_infer",
    "rms_norm", "norm", "cosine_similarity",
}

white_list = WHITE_LIST


class _AmpState(threading.local):
    # thread-local by design (one autocast stack per thread)
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.custom_white, _state.custom_black)
    _state.enabled = enable
    _state.dtype = convert_dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = prev


amp_guard = auto_cast


def amp_state():
    """This thread's autocast settings as a hashable tuple (what a
    captured step's casts were recorded under)."""
    return (_state.enabled, str(_state.dtype), _state.level,
            tuple(sorted(_state.custom_white)),
            tuple(sorted(_state.custom_black)))



def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' float parameters to the AMP dtype in place."""
    dt = convert_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    with torch.no_grad():
        for m in model_list:
            for p in m.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dt)
    out = models if single else model_list
    return out if optimizers is None else (out, optimizers)


def _cast_args(name, args):
    white = (WHITE_LIST | _state.custom_white) - _state.custom_black
    dt = _state.dtype
    if name in white:
        return tuple(a.to(dt) if isinstance(a, torch.Tensor)
                     and a.is_floating_point() else a for a in args)
    if name in BLACK_LIST | _state.custom_black:
        return tuple(a.float() if isinstance(a, torch.Tensor)
                     and a.dtype == dt else a for a in args)
    return args


def maybe_cast_inputs(op_name, tensors):
    """The float tensors of ``tensors`` cast to the AMP dtype when
    autocast is on and ``op_name`` is white-listed (``_cast_args``'s
    rule); otherwise ``tensors`` as they are."""
    if not _state.enabled:
        return tensors
    if op_name not in (WHITE_LIST | _state.custom_white) - \
            _state.custom_black:
        return tensors
    return list(_cast_args(op_name, tensors))


def is_enabled():
    """Whether this thread is inside an enabled ``auto_cast``."""
    return _state.enabled
