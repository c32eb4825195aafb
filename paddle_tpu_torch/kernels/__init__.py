"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``paged_attention.py``: ragged paged attention)."""
