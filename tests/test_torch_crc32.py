"""The sentinel's device CRC (``kernels/crc32.py``, ``csrc/crc32.cu``) on
the CPU: its plain version, which computes the digest the way the kernel
does (1 KiB units from a zero register, 256 KiB blocks counted from the
end, shifts by x^(8k) modulo the polynomial), and zlib's ``multmodp`` /
``x2nmodp`` / ``crc32_combine`` in Python, equal ``zlib.crc32`` over
random lengths; and ``tree_fingerprint`` is the JAX formula for every
dtype, bf16 under the ``'<V2'`` header included.  The kernel itself runs
only on the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``
phase 19 (f))."""
import zlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import crc32
from paddle_tpu_torch.resilience.integrity import tree_fingerprint

LENGTHS = [0, 1, 2, 15, 16, 1023, 1024, 1025, 7919, 262143, 262144,
           262145, 1000003, 4 << 20]


@pytest.mark.parametrize("n", LENGTHS)
def test_plain_version_equals_zlib(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    header = zlib.crc32(b"<f4:(7,)")
    assert crc32._crc32_ref(data, header) == zlib.crc32(data.tobytes(),
                                                        header)
    assert crc32._crc32_ref(data, 0) == zlib.crc32(data.tobytes())


@pytest.mark.parametrize("n", LENGTHS)
def test_combine_equals_zlib(n):
    data = np.random.default_rng(n + 1).integers(0, 256, n,
                                                 dtype=np.uint8).tobytes()
    for cut in {0, n // 3, n}:
        a, b = data[:cut], data[cut:]
        assert crc32.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) \
            == zlib.crc32(data)


def test_slicing_tables_step_16_bytes_as_16_single_steps():
    """The kernel's step (``crc16`` in ``csrc/crc32.cu``): byte i of 16,
    the first four XORed with the register, looked up in table 15 - i."""
    t = crc32._slicing_tables(crc32.TABLE)
    assert len(t) == 16 * 256 and t[:256] == crc32.TABLE
    rng = np.random.default_rng(0)
    for _ in range(100):
        c = int(rng.integers(0, 1 << 32, dtype=np.uint64))
        data = rng.integers(0, 256, 16).tolist()
        first = c ^ int.from_bytes(bytes(data[:4]), "little")
        sliced = 0
        for i in range(16):
            byte = (first >> 8 * i) & 0xFF if i < 4 else data[i]
            sliced ^= t[(15 - i) * 256 + byte]
        one = c
        for byte in data:
            one = crc32.TABLE[(one ^ byte) & 0xFF] ^ (one >> 8)
        assert sliced == one


DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
          torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
          torch.bool, torch.complex64]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fingerprint_is_the_jax_formula(dtype):
    """The leaf digest is crc32(bytes, crc32(f"{dtype.str}:{shape}")) with
    bf16 as '<V2', on the host (zlib) and by the plain version."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(5, 7, generator=g) * 50).to(dtype)
    if dtype == torch.complex64:
        x = torch.complex(torch.randn(5, 7, generator=g),
                          torch.randn(5, 7, generator=g))
    raw = (x.view(torch.int16) if dtype == torch.bfloat16 else x).numpy()
    dstr = "<V2" if dtype == torch.bfloat16 else raw.dtype.str
    want = zlib.crc32(raw.tobytes(), zlib.crc32(f"{dstr}:(5, 7)".encode()))
    assert tree_fingerprint({"x": x}) == {"x": want}
    from paddle_tpu_torch.resilience import integrity

    assert crc32.crc32_leaves([x], [integrity._header_crc(x)]) == [want]
    zero_d = x[0, 0]
    assert tree_fingerprint({"s": zero_d})["s"] == crc32.crc32_leaves(
        [zero_d], [integrity._header_crc(zero_d)])[0]


def test_plain_version_takes_views_and_empty_leaves():
    from paddle_tpu_torch.resilience import integrity

    base = torch.arange(60, dtype=torch.float32).reshape(6, 10)
    leaves = [base[:, 2:7], torch.zeros(0, 3), torch.tensor(2.5)]
    got = crc32.crc32_leaves(leaves, [integrity._header_crc(t)
                                      for t in leaves])
    assert got == [integrity._leaf_crc(t) for t in leaves]
