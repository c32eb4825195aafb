"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``paged_attention.py``: ragged paged attention;
``flash_attention.py``: flash attention forward, dK/dV and dQ;
``ring_attention.py``: ring attention's per-pair backward, around the
flash forward; ``crc32.py``: zlib's CRC-32 of many tensors in one
launch, the integrity sentinel's digests).

``ring_attention`` here is the function; its module is
``importlib.import_module("paddle_tpu_torch.kernels.ring_attention")``."""
from .ring_attention import ring_attention

__all__ = ["ring_attention"]
