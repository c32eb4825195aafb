"""zlib's CRC-32 of many tensors at once — the integrity sentinel's leaf
digests (``resilience/integrity.py``).

``crc32_leaves(tensors, headers)`` returns, for each tensor ``t`` and
header CRC ``h``, ``zlib.crc32(bytes of t, h)``: on the card one launch
of ``csrc/crc32.cu`` for all of them and one copy of the words back; on
the CPU the plain version ``_crc32_ref``, which computes the same
digest the way the kernel does (1 KiB units, 256 KiB blocks counted
from the end, shifts by ``x^(8k)`` modulo the polynomial) and equals
``zlib.crc32``.  A call is two kernels (the blocks, then a combine a
leaf), counted as one launch.  The kernel replaces no TPU kernel: the JAX package
digests on the host with ``zlib`` after a device-to-host copy.

``multmodp``, ``x2nmodp`` and ``crc32_combine`` are zlib's, in Python.
``crc32_leaves.launches`` counts kernel launches.  Nothing is built at
import: the kernel is compiled at its first launch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["crc32_leaves", "crc32_combine", "multmodp", "x2nmodp"]

POLY = 0xEDB88320
UNIT = 1024            # bytes a thread digests (2^13 bits)
BLOCK_BYTES = 262144   # bytes a block digests: 256 units (2^21 bits)


def _byte_table():
    out = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        out.append(c)
    return out


def multmodp(a, b):
    """a * b modulo the CRC polynomial (reflected; zlib ``multmodp``)."""
    p = 0
    for i in range(31, -1, -1):
        if a >> i & 1:
            p ^= b
        b = (b >> 1) ^ POLY if b & 1 else b >> 1
    return p


def _x2n_table():
    out, p = [], 1 << 30          # x^1
    for _ in range(32):
        out.append(p)
        p = multmodp(p, p)
    return out


SLICING = 16           # bytes a table step of the kernel


def _slicing_tables(t0):
    """The ``SLICING`` tables of slicing by 16, concatenated: T[k][i] is
    T[k-1][i] moved one zero byte on (the CRC of byte i followed by k
    zero bytes)."""
    tables = [t0]
    for _ in range(SLICING - 1):
        prev = tables[-1]
        tables.append([(c >> 8) ^ t0[c & 0xFF] for c in prev])
    return [c for t in tables for c in t]


TABLE = _byte_table()
X2N = _x2n_table()             # X2N[k] = x^(2^k) modulo the polynomial


def x2nmodp(n, k):
    """x^(n * 2^k) modulo the polynomial (zlib ``x2nmodp``)."""
    p = 1 << 31                # x^0
    while n:
        if n & 1:
            p = multmodp(X2N[k & 31], p)
        n >>= 1
        k += 1
    return p


def crc32_combine(crc1, crc2, len2):
    """The CRC of A || B from crc(A), crc(B) and len(B) (zlib's)."""
    return multmodp(x2nmodp(len2, 3), crc1) ^ crc2


# ------------------------------------------------------------ plain version


def _mult_vec(a, b):
    """multmodp of one constant ``a`` with each element of ``b``."""
    p = np.zeros_like(b)
    for i in range(31, -1, -1):
        if a >> i & 1:
            p ^= b
        b = np.where(b & 1, (b >> 1) ^ np.uint32(POLY), b >> 1)
    return p


_TABLE_NP = np.array(TABLE, dtype=np.uint32)


def _crc32_ref(data, header):
    """``zlib.crc32(data, header)`` for a uint8 array, computed as the
    kernel does: zeros in front up to whole 256 KiB blocks, each 1 KiB
    unit's register from 0, the units of a block combined in a tree,
    blocks shifted past the ones after them, the header's register
    moved past the data."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = data.size
    nblocks = max(1, -(-n // BLOCK_BYTES))
    padded = np.zeros(nblocks * BLOCK_BYTES, np.uint8)
    padded[padded.size - n:] = data
    units = padded.reshape(-1, UNIT)
    r = np.zeros(units.shape[0], np.uint32)
    for j in range(UNIT):
        r = _TABLE_NP[(r ^ units[:, j]) & 0xFF] ^ (r >> 8)
    r = r.reshape(nblocks, BLOCK_BYTES // UNIT)
    span, level = 1, 13        # the right half of a pair: span KiB
    while span < r.shape[1]:
        r[:, ::2 * span] = (_mult_vec(X2N[level], r[:, ::2 * span])
                            ^ r[:, span::2 * span])
        span, level = 2 * span, level + 1
    acc = 0
    for block in r[:, 0].tolist():
        acc = multmodp(X2N[21], acc) ^ int(block)   # 2^18 bytes a block
    moved = multmodp(x2nmodp(n, 3), header ^ 0xFFFFFFFF)
    return (acc ^ moved ^ 0xFFFFFFFF) & 0xFFFFFFFF


# ------------------------------------------------------------------ kernel


def _kernel_fn():
    from . import _build

    fn = _build.load("crc32").crc32_leaves_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_tables = {}       # device -> uint32[16 * 256 + 32]: slicing tables, X2N


def _device_tables(device):
    key = str(device)
    if key not in _tables:
        words = np.array(_slicing_tables(TABLE) + X2N, dtype=np.uint32)
        _tables[key] = torch.from_numpy(words.view(np.int32)).to(device)
    return _tables[key]


_moved = {}        # (bytes, header) -> M_n(~header)


def _moved_header(n, header):
    """The header's register moved past ``n`` data bytes, M_n(~header)
    (a leaf table word; the same sizes and headers come back call after
    call)."""
    key = (n, header & 0xFFFFFFFF)
    word = _moved.get(key)
    if word is None:
        word = multmodp(x2nmodp(n, 3), key[1] ^ 0xFFFFFFFF)
        _moved[key] = word
    return word


def _prepare(tensors, headers):
    """The leaf table of a call, on the card, and its buffers: ``(launch,
    keep)``, ``launch()`` enqueueing both kernels on the current stream
    (and counting one launch) and returning the words, ``keep`` the
    tensors it reads."""
    device = tensors[0].device
    meta = np.empty((len(tensors), 4), np.int64)
    keep, first = [], 0
    for i, (t, h) in enumerate(zip(tensors, headers)):
        if t.device != device:
            raise ValueError("crc32_leaves: tensors on several devices")
        if not t.is_contiguous():
            t = t.contiguous()
        keep.append(t)
        n = t.numel() * t.element_size()
        meta[i] = (t.data_ptr(), n, first, _moved_header(n, h))
        first += max(1, -(-n // BLOCK_BYTES))
    leaves = torch.from_numpy(meta).to(device)
    block_crc = torch.empty(first, dtype=torch.int32, device=device)
    out = torch.empty(len(tensors), dtype=torch.int32, device=device)
    fn, tables = _kernel_fn(), _device_tables(device)
    args = (tables.data_ptr(), leaves.data_ptr(), len(tensors), first,
            block_crc.data_ptr(), out.data_ptr())

    def launch():
        if torch.cuda.current_device() != device.index:
            with torch.cuda.device(device):
                return launch()
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"crc32 kernel launch failed: CUDA error {rc}")
        crc32_leaves.launches += 1
        return out

    launch.buffers = (leaves, block_crc)   # alive as long as the launch
    return launch, keep


_plans = {}        # device -> (key, launch) of the last call


def _crc32_cuda(tensors, headers):
    """One launch and one read back.  The sentinel digests the same
    parameters every time: a call whose leaves (pointers, sizes, headers)
    equal the last call's on that device reuses that call's leaf table
    and buffers, already on the card, and skips the host loop and the
    copy."""
    device = tensors[0].device
    key = tuple((t.data_ptr(), t.nbytes, h) if t.is_contiguous() else None
                for t, h in zip(tensors, headers))
    plan = _plans.get(device)
    if plan is not None and plan[0] == key and None not in key:
        out = plan[1]()
    else:
        launch, keep = _prepare(tensors, headers)
        _plans[device] = (key, launch)
        out = launch()
    words = out.cpu().numpy().view(np.uint32)   # the one sync
    return [int(w) for w in words]


def crc32_leaves(tensors, headers):
    """``[zlib.crc32(bytes of t, h) for t, h in zip(tensors, headers)]``:
    CUDA tensors (all on one device) in one kernel launch, CPU tensors by
    the plain version.  A tensor's bytes are its C-order storage (bf16 as
    its uint16 bits)."""
    tensors = list(tensors)
    if not tensors:
        return []
    if tensors[0].is_cuda:
        return _crc32_cuda(tensors, list(headers))
    out = []
    for t, h in zip(tensors, headers):
        if t.is_cuda:
            raise ValueError("crc32_leaves: CPU and CUDA tensors mixed")
        t = t.detach().contiguous()
        raw = t.reshape(-1).view(torch.uint8) if t.numel() else \
            torch.empty(0, dtype=torch.uint8)
        out.append(_crc32_ref(raw.numpy(), h & 0xFFFFFFFF))
    return out


crc32_leaves.launches = 0
