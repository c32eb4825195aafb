"""The port's ``fft`` and ``signal`` against the JAX package's on the same
seeded inputs at fp32 1e-5 (complex64 outputs compared as such).

Every transform of ``fft`` runs with each norm; ``frame`` /
``overlap_add`` on both axes; ``stft`` / ``istft`` over windows,
padding modes, ``onesided`` and ``normalized``, with the gradient of a
real function of the spectrum held to ``jax.grad``'s, and the round trip
``istft(stft(x)) == x``.  Two comparisons use atol 1e-4 (rtol stays
1e-5): the raw transforms' outputs, whose entries are unnormalised sums
of up to 48 unit-variance terms (magnitudes near 10), and the stft
gradient, a sum over every frame a sample falls in; torch's pocketfft
and XLA's FFT sum in other orders, so their last bits differ at that
magnitude."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fft as jfft
import paddle_tpu.signal as jsig

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fft as tfft
import paddle_tpu_torch.signal as tsig

tpaddle.set_device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)


def rand(shape, seed, complex_=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    if complex_:
        x = (x + 1j * rng.randn(*shape)).astype(np.complex64)
    return x


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().resolve_conj().numpy(),
                               np.asarray(want), **(tol or TOL))


ONE_D = [("fft", True), ("ifft", True), ("rfft", False), ("irfft", True),
         ("hfft", True), ("ihfft", False)]


@pytest.mark.parametrize("name,cplx", ONE_D, ids=[n for n, _ in ONE_D])
@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_one_dim_transforms_match_jax(name, cplx, norm):
    x = rand((3, 10), 0, cplx)
    for kw in ({}, {"n": 8, "axis": 0}, {"n": 12}):
        if "axis" in kw and name in ("hfft", "irfft"):
            kw = {"n": 6, "axis": 0}
        want = getattr(jfft, name)(x, norm=norm, **kw)
        got = getattr(tfft, name)(torch.tensor(x), norm=norm, **kw)
        close(got, want, atol=1e-4, rtol=1e-5)


MULTI = [("fft2", True), ("ifft2", True), ("rfft2", False),
         ("irfft2", True), ("fftn", True), ("ifftn", True),
         ("rfftn", False), ("irfftn", True)]


@pytest.mark.parametrize("name,cplx", MULTI, ids=[n for n, _ in MULTI])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_multi_dim_transforms_match_jax(name, cplx, norm):
    x = rand((2, 6, 8), 1, cplx)
    want = getattr(jfft, name)(x, norm=norm)
    got = getattr(tfft, name)(torch.tensor(x), norm=norm)
    close(got, want, atol=1e-4, rtol=1e-5)
    kw = {"s": (4, 6)} if name.endswith("2") else {"s": (4, 6),
                                                   "axes": (0, 2)}
    want = getattr(jfft, name)(x, norm=norm, **kw)
    got = getattr(tfft, name)(torch.tensor(x), norm=norm, **kw)
    close(got, want, atol=1e-4, rtol=1e-5)


def test_frequencies_and_shifts_match_jax():
    for n, d in ((8, 1.0), (9, 0.5)):
        close(tfft.fftfreq(n, d), np.asarray(jfft.fftfreq(n, d).data))
        close(tfft.rfftfreq(n, d), np.asarray(jfft.rfftfreq(n, d).data))
    assert tfft.fftfreq(4, dtype="float64").dtype == torch.float64
    x = rand((5, 6), 2)
    for axes in (None, 0, (0, 1)):
        close(tfft.fftshift(torch.tensor(x), axes),
              jfft.fftshift(x, axes))
        close(tfft.ifftshift(torch.tensor(x), axes),
              jfft.ifftshift(x, axes))


def test_fft_gradient_matches_jax():
    x = rand((4, 16), 3)
    ct = rand((4, 9), 4)

    def jf(a):
        return jnp.sum(jnp.abs(jfft.rfft(a, norm="ortho")) * ct)

    want = jax.grad(jf)(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    (torch.abs(tfft.rfft(tx, norm="ortho")) * torch.tensor(ct)).sum() \
        .backward()
    close(tx.grad, want)


# ----------------------------------------------------------------- signal


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("flen,hop", [(4, 2), (5, 5), (7, 3)])
def test_frame_and_overlap_add_match_jax(axis, flen, hop):
    x = rand((3, 20) if axis == -1 else (20, 3), 5)
    want = jsig.frame(x, flen, hop, axis=axis)
    got = tsig.frame(torch.tensor(x), flen, hop, axis=axis)
    close(got, want)
    close(tsig.overlap_add(got.contiguous(), hop, axis=axis),
          jsig.overlap_add(np.asarray(want), hop, axis=axis))


def test_signal_axis_checks_are_loud():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="axis 0 or -1"):
        tsig.frame(x, 2, 1, axis=1)
    with pytest.raises(ValueError, match="frame_length"):
        tsig.frame(x, 9, 1)
    with pytest.raises(ValueError, match="hop_length"):
        tsig.frame(x, 2, 0)
    with pytest.raises(ValueError, match="axis 0 or -1"):
        tsig.overlap_add(x[None], 1, axis=1)


STFTS = {
    "rect_reflect": dict(n_fft=16, hop_length=4),
    "hann_constant": dict(n_fft=16, hop_length=5, window="hann",
                          pad_mode="constant"),
    "short_window_normalized": dict(n_fft=16, hop_length=4, win_length=10,
                                    window="hann", normalized=True),
    "twosided_nocenter": dict(n_fft=12, hop_length=3, window="hann",
                              onesided=False, center=False),
}


def _win(kw):
    kw = dict(kw)
    if kw.get("window") == "hann":
        n = kw.get("win_length", kw["n_fft"])
        kw["window"] = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)) \
            .astype(np.float32)
    return kw


@pytest.mark.parametrize("case", sorted(STFTS))
def test_stft_and_its_gradient_match_jax(case):
    kw = _win(STFTS[case])
    x = rand((2, 64), 6)
    want = jsig.stft(x, **kw)
    a, b = rand(want.shape, 7), rand(want.shape, 9)

    def jloss(v):   # a real function of the spectrum
        spec = jsig.stft(v, **kw)
        return jnp.sum(jnp.real(spec) * a + jnp.imag(spec) * b)

    gwant = jax.grad(jloss)(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = tsig.stft(tx, **tkw)
    close(got, want)
    (got.real * torch.tensor(a) + got.imag * torch.tensor(b)).sum() \
        .backward()
    close(tx.grad, gwant, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(STFTS))
def test_istft_matches_jax_and_inverts(case):
    kw = _win(STFTS[case])
    x = rand((2, 64), 8)
    spec = np.asarray(jsig.stft(x, **kw))
    ikw = {k: v for k, v in kw.items() if k != "pad_mode"}
    want = jsig.istft(spec, length=64, **ikw)
    tkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in ikw.items()}
    got = tsig.istft(torch.tensor(spec), length=64, **tkw)
    close(got, want)
    if kw.get("center", True) and case != "hann_constant":
        close(got, x, atol=1e-5, rtol=1e-4)
