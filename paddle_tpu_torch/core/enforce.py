"""Curated error framework (the port of ``paddle_tpu/core/enforce.py``,
copied: it is plain Python; reference parity: paddle/phi/core/enforce.h
PADDLE_ENFORCE_* + the 12-kind error taxonomy of
paddle/utils/error_codes, surfaced in Python as paddle.base errors).

There is no C++ stack to demangle: the value of the
reference system is (a) a stable error taxonomy callers can catch, and
(b) messages that say WHAT was violated and WHICH argument did it.
``enforce_*`` helpers raise those typed errors with formatted context;
framework code uses them where a bare assert would lose the story.
"""
from __future__ import annotations

__all__ = [
    "EnforceNotMet", "InvalidArgumentError", "NotFoundError",
    "OutOfRangeError", "AlreadyExistsError", "ResourceExhaustedError",
    "PreconditionNotMetError", "PermissionDeniedError", "ExecutionTimeoutError",
    "UnimplementedError", "UnavailableError", "FatalError", "ExternalError",
    "enforce", "enforce_eq", "enforce_gt", "enforce_shape",
]


class EnforceNotMet(RuntimeError):
    """Base of the taxonomy (enforce.h EnforceNotMet)."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet):
    pass


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class PermissionDeniedError(EnforceNotMet, PermissionError):
    pass


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


class FatalError(EnforceNotMet):
    pass


class ExternalError(EnforceNotMet):
    pass


def enforce(cond, msg, *fmt_args, error_cls=InvalidArgumentError):
    """PADDLE_ENFORCE: raise ``error_cls`` with the formatted message when
    ``cond`` is falsy."""
    if not cond:
        raise error_cls(msg.format(*fmt_args) if fmt_args else msg)


def enforce_eq(a, b, what="value", error_cls=InvalidArgumentError):
    if a != b:
        raise error_cls(
            f"{what} mismatch: expected {b!r}, got {a!r}")


def enforce_gt(a, b, what="value", error_cls=InvalidArgumentError):
    if not a > b:
        raise error_cls(f"{what} must be > {b!r}, got {a!r}")


def enforce_shape(x, expected, what="tensor"):
    """Shape check with -1 wildcards (InferShape-style message)."""
    shape = tuple(getattr(x, "shape", ()))
    ok = len(shape) == len(expected) and all(
        e in (-1, None) or s == e for s, e in zip(shape, expected))
    if not ok:
        raise InvalidArgumentError(
            f"{what} shape mismatch: expected "
            f"{tuple(e if e not in (None,) else -1 for e in expected)}, "
            f"got {shape}")
