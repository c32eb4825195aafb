"""Shared helpers of the eager-API parity tests (``test_torch_nn.py``,
``test_torch_vision*.py``, ``test_torch_amp.py``, ``test_torch_hapi.py``,
``test_torch_transformer.py``): the JAX side runs jitted through
``raw_state``/``swap_state`` and ``jax.value_and_grad``, the port's
eagerly on the CPU; weights cross through ``layer_state_from_jax``, and
inputs and cotangents are made with numpy from seeds."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.models import layer_state_from_jax

tpaddle.set_device("cpu")


def rand(shape, seed, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      dtype=np.float32)


def jax_state(jlayer):
    """A JAX layer's ``state_dict()`` as numpy."""
    return {k: np.asarray(v.data) for k, v in jlayer.state_dict().items()}


def carry(jlayer, tlayer):
    """Load the JAX layer's weights and buffers into the port's layer;
    every name must match."""
    missing, unexpected = tlayer.set_state_dict(
        layer_state_from_jax(jax_state(jlayer), device="cpu"))
    assert not missing and not unexpected, (missing, unexpected)
    return tlayer


def pair(jctor, tctor, seed=0):
    """Build one layer in each package and carry the JAX weights over;
    returns ``(jax_layer, port_layer)``."""
    jpaddle.seed(seed)
    tpaddle.seed(seed)
    jlayer = jctor()
    return jlayer, carry(jlayer, tctor())


def jax_vjp(jlayer, x, ct_seed=1, train=True, loss_fn=None, y=None):
    """Jitted forward and gradient of the JAX layer at ``x``: returns
    ``(out, loss, {param: grad}, grad_x, {buffer: value after})``.
    Without ``loss_fn`` the loss is ``sum(out * ct)`` with a seeded
    cotangent ``ct``."""
    (jlayer.train if train else jlayer.eval)()
    params, buffers = jlayer.raw_state()

    def fwd(params, buffers, x):
        with jlayer.swap_state(params, buffers):
            out = jlayer(jpaddle.Tensor(x))
            nb = {k: b.data for k, b in jlayer.named_buffers()
                  if b is not None}
        return out.data, nb

    out_shape = jax.eval_shape(fwd, params, buffers, x)[0].shape
    ct = jnp.asarray(rand(out_shape, ct_seed))

    def loss(params, x):
        out, nb = fwd(params, buffers, x)
        if loss_fn is None:
            val = jnp.sum(out.astype(jnp.float32) * ct)
        else:
            with jlayer.swap_state(params, buffers):
                val = loss_fn(jpaddle.Tensor(out),
                              jpaddle.Tensor(y)).data
        return val, (out, nb)

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (val, (out, nb)), (gp, gx) = step(params, jnp.asarray(x))
    np_ = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    return (np.asarray(out), float(val), np_(gp), np.asarray(gx), np_(nb))


def torch_vjp(tlayer, x, ct_seed=1, train=True, loss_fn=None, y=None):
    """The port's counterpart of ``jax_vjp``, eager on the CPU."""
    (tlayer.train if train else tlayer.eval)()
    params = dict(tlayer.named_parameters())
    tx = torch.tensor(x, requires_grad=True)
    out = tlayer(tx)
    if loss_fn is None:
        ct = torch.from_numpy(rand(tuple(out.shape), ct_seed))
        val = (out.float() * ct).sum()
    else:
        val = loss_fn(out, torch.as_tensor(y))
    grads = torch.autograd.grad(val, list(params.values()) + [tx],
                                allow_unused=True)
    gp = {k: (np.zeros(tuple(p.shape), np.float32) if g is None
              else g.detach().float().numpy())
          for (k, p), g in zip(params.items(), grads[:-1])}
    nb = {k: b.detach().float().numpy() for k, b in tlayer.named_buffers()}
    return (out.detach().float().numpy(), float(val), gp,
            grads[-1].detach().float().numpy(), nb)


def assert_close_dicts(a, b, **tol):
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


def assert_vjp_close(j, t, **tol):
    """Outputs, losses, parameter and input gradients and buffers of
    ``jax_vjp`` and ``torch_vjp`` agree at ``tol``."""
    jo, jl, jg, jgx, jb = j
    to, tl, tg, tgx, tb = t
    np.testing.assert_allclose(to, jo, err_msg="out", **tol)
    np.testing.assert_allclose(tl, jl, err_msg="loss", **tol)
    assert_close_dicts(tg, jg, **tol)
    np.testing.assert_allclose(tgx, jgx, err_msg="grad x", **tol)
    assert_close_dicts(tb, jb, **tol)
