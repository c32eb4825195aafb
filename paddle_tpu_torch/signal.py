"""Signal processing: frame / overlap_add / stft / istft (the port of
``paddle_tpu/signal.py``; reference parity: python/paddle/signal.py over
the frame_op/overlap_add ops and paddle.fft).

Framing is a strided view (``unfold``), overlap-add is ``fold``'s col2im
(one gathering sum per output sample, so the card sums in a fixed order)
and the transforms are ``torch.fft``'s, on the device of the input.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["frame", "overlap_add", "stft", "istft"]

# jnp.pad's modes by their torch names
_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "wrap": "circular"}


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _check_axis(axis, what):
    if axis not in (0, -1):
        raise ValueError(f"{what} supports axis 0 or -1 (reference "
                         f"signal.py contract), got {axis}")


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Slice ``x`` into overlapping frames (reference signal.py frame).
    axis=-1: (..., n) → (..., frame_length, num_frames);
    axis=0:  (n, ...) → (frame_length, num_frames, ...)."""
    _check_axis(axis, "frame")
    a = _t(x)
    if frame_length > a.shape[axis]:
        raise ValueError(
            f"frame_length ({frame_length}) > axis size ({a.shape[axis]})")
    if hop_length <= 0:
        raise ValueError("hop_length must be positive")
    if axis == 0:
        a = torch.movedim(a, 0, -1)
    out = a.unfold(-1, frame_length, hop_length)         # [..., num, flen]
    out = out.transpose(-1, -2)                          # [..., flen, num]
    if axis == 0:
        out = torch.movedim(out, (-2, -1), (0, 1))       # [flen, num, ...]
    return out


def overlap_add(x, hop_length, axis=-1, name=None):
    """Inverse of frame: sum overlapping frames (reference overlap_add).
    axis=-1: (..., frame_length, num) → (..., n);
    axis=0:  (frame_length, num, ...) → (n, ...)."""
    _check_axis(axis, "overlap_add")
    a = _t(x)
    if axis == 0:
        a = torch.movedim(a, (0, 1), (-2, -1))
    flen, num = a.shape[-2], a.shape[-1]
    n = (num - 1) * hop_length + flen
    lead = a.shape[:-2]
    cols = a.reshape(-1, flen, num)
    if cols.is_complex():
        out = torch.complex(_fold(cols.real, n, flen, hop_length),
                            _fold(cols.imag, n, flen, hop_length))
    else:
        out = _fold(cols, n, flen, hop_length)
    out = out.reshape(*lead, n)
    if axis == 0:
        out = torch.movedim(out, -1, 0)
    return out


def _fold(cols, n, flen, hop):
    """[B, flen, num] frames summed into [B, n] (col2im on a 1 x n
    image)."""
    return F.fold(cols, output_size=(1, n), kernel_size=(1, flen),
                  stride=(1, hop)).reshape(cols.shape[0], n)


def _window(window, win_length, n_fft, device):
    if window is None:
        win = torch.ones((win_length,), dtype=torch.float32, device=device)
    else:
        win = _t(window).to(device=device, dtype=torch.float32)
    # center-pad the window to n_fft (reference behavior)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = F.pad(win, (lpad, n_fft - win_length - lpad))
    return win


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False,
         onesided=True, name=None):
    """Short-time Fourier transform (reference signal.py stft).
    x: [..., n]; returns [..., n_fft//2+1 or n_fft, num_frames] complex."""
    a = _t(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = _window(window, win_length, n_fft, a.device)
    if center:
        pad = n_fft // 2
        if pad_mode not in _PAD_MODES:
            raise ValueError(f"stft: pad_mode {pad_mode!r} is not one of "
                             f"{sorted(_PAD_MODES)}")
        lead = a.shape[:-1]
        a = F.pad(a.reshape(-1, 1, a.shape[-1]), (pad, pad),
                  mode=_PAD_MODES[pad_mode]).reshape(*lead, -1)
    frames = frame(a, n_fft, hop_length)                 # [..., n_fft, num]
    frames = frames.transpose(-1, -2) * win              # [..., num, n_fft]
    spec = (torch.fft.rfft(frames, n=n_fft, dim=-1) if onesided
            else torch.fft.fft(frames, n=n_fft, dim=-1))
    if normalized:
        spec = spec / np.sqrt(np.float32(n_fft))
    return spec.transpose(-1, -2)                        # [..., freq, num]


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """Inverse STFT with the standard window-square normalization
    (reference signal.py istft)."""
    spec = _t(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = _window(window, win_length, n_fft, spec.device)
    if normalized:
        spec = spec * np.sqrt(np.float32(n_fft))
    frames = spec.transpose(-1, -2)                      # [..., num, freq]
    t = (torch.fft.irfft(frames, n=n_fft, dim=-1) if onesided
         else torch.fft.ifft(frames, n=n_fft, dim=-1))
    if not return_complex and t.is_complex():
        t = t.real
    t = t * win
    y = overlap_add(t.transpose(-1, -2), hop_length)
    # window-square envelope normalization
    num = frames.shape[-2]
    wsq = (win * win)[None, :].expand(num, n_fft)
    env = overlap_add(wsq.transpose(-1, -2), hop_length)
    y = y / torch.clamp(env, min=1e-10)
    if center:
        pad = n_fft // 2
        y = y[..., pad:y.shape[-1] - pad]
    if length is not None:
        y = y[..., :length]
    return y
