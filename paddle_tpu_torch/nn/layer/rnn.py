"""Recurrent layers (the port of ``paddle_tpu/nn/layer/rnn.py``; parity:
python/paddle/nn/layer/rnn.py).

The parameters keep the JAX package's names and shapes (``weight_ih``
[G·hidden, input], ``weight_hh`` [G·hidden, hidden], ``bias_ih``,
``bias_hh``) and its gate orders: (i, f, g, o) for the LSTM and (r, z,
n) for the GRU.  ``RNN`` runs the cell's time loop in Python, as the JAX
package's eager path does, with the input projection of every step done
as one product before the loop (the same sums, per step, in the same
order).  On the card ``hapi``'s ``train_batch`` captures the whole step
as one CUDA graph, so the loop costs no host time there.

``initial_states`` of the multi-layer ``SimpleRNN`` / ``LSTM`` / ``GRU``
is honoured, as in Paddle (the JAX package drops it): Paddle's layout
(``[L·D, B, H]``, and ``(h, c)`` of that for the LSTM) or a list of one
state per layer and direction.
"""
from __future__ import annotations

import math

import torch

from ... import ops
from ..initializer import Uniform
from .layers import Layer, LayerList

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "SimpleRNN",
           "LSTM", "GRU"]


class _CellBase(Layer):
    GATES = 1

    def __init__(self, input_size, hidden_size):
        super().__init__()
        k = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-k, k)
        G = self.GATES * hidden_size
        self.hidden_size = hidden_size
        self.weight_ih = self.create_parameter(
            [G, input_size], default_initializer=init)
        self.weight_hh = self.create_parameter(
            [G, hidden_size], default_initializer=init)
        self.bias_ih = self.create_parameter(
            [G], is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [G], is_bias=True, default_initializer=init)

    def _zeros(self, x):
        return torch.zeros((x.shape[-2], self.hidden_size), dtype=x.dtype,
                           device=x.device)

    def project_input(self, x):
        """The input's share of the gates, ``x Wᵢₕᵀ + bᵢₕ`` (any leading
        dims: ``RNN`` projects every step at once)."""
        return ops.matmul(x, self.weight_ih.t()) + self.bias_ih

    def forward(self, x, state=None):
        return self.step(self.project_input(x), state)


class SimpleRNNCell(_CellBase):
    def __init__(self, input_size, hidden_size, activation="tanh"):
        super().__init__(input_size, hidden_size)
        self.activation = getattr(ops, activation)

    def step(self, xp, h=None):
        if h is None:
            h = self._zeros(xp)
        pre = xp + ops.matmul(h, self.weight_hh.t()) + self.bias_hh
        h_new = self.activation(pre)
        return h_new, h_new


class LSTMCell(_CellBase):
    GATES = 4

    def step(self, xp, state=None):
        if state is None:
            z = self._zeros(xp)
            state = (z, z)
        h, c = state
        gates = xp + ops.matmul(h, self.weight_hh.t()) + self.bias_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRUCell(_CellBase):
    GATES = 3

    def step(self, xp, h=None):
        if h is None:
            h = self._zeros(xp)
        gh = ops.matmul(h, self.weight_hh.t()) + self.bias_hh
        i_r, i_z, i_n = torch.chunk(xp, 3, dim=-1)
        h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h_new = (1.0 - z) * n + z * h
        return h_new, h_new


class RNN(Layer):
    """Runs a cell over time (parity: paddle.nn.RNN)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None):
        # inputs: [B, T, F] (batch-major) or [T, B, F]
        if not self.time_major:
            inputs = inputs.transpose(0, 1)
        T = inputs.shape[0]
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        xp = self.cell.project_input(inputs)
        outputs = []
        state = initial_states
        for t in steps:
            out, state = self.cell.step(xp[t], state)
            outputs.append(out)
        if self.is_reverse:
            outputs = outputs[::-1]
        out = torch.stack(outputs, dim=0)
        if not self.time_major:
            out = out.transpose(0, 1)
        return out, state


class _MultiLayerRNN(Layer):
    CELL = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.time_major = time_major
        self.dropout = dropout
        layers = []
        num_dir = 2 if self.bidirectional else 1
        for i in range(num_layers):
            in_sz = input_size if i == 0 else hidden_size * num_dir
            layers.append(RNN(self.CELL(in_sz, hidden_size),
                              time_major=time_major))
            if self.bidirectional:
                layers.append(RNN(self.CELL(in_sz, hidden_size),
                                  is_reverse=True, time_major=time_major))
        self.layers = LayerList(layers)

    def _split_states(self, initial_states):
        """One initial state per layer and direction (None: zeros)."""
        n = len(self.layers)
        if initial_states is None:
            return [None] * n
        if isinstance(initial_states, torch.Tensor):
            return list(initial_states.unbind(0))
        if (isinstance(initial_states, tuple) and len(initial_states) == 2
                and all(isinstance(s, torch.Tensor) and s.ndim == 3
                        for s in initial_states)):
            h, c = initial_states
            return list(zip(h.unbind(0), c.unbind(0)))
        states = list(initial_states)
        if len(states) != n:
            raise ValueError(f"initial_states: {len(states)} states for "
                             f"{n} layers x directions")
        return states

    def forward(self, inputs, initial_states=None):
        states = self._split_states(initial_states)
        out = inputs
        final_states = []
        for i in range(self.num_layers):
            if self.bidirectional:
                fwd, sf = self.layers[2 * i](out, states[2 * i])
                bwd, sb = self.layers[2 * i + 1](out, states[2 * i + 1])
                out = torch.cat([fwd, bwd], dim=-1)
                final_states.extend([sf, sb])
            else:
                out, s = self.layers[i](out, states[i])
                final_states.append(s)
            if self.dropout > 0 and i < self.num_layers - 1:
                out = ops.dropout(out, p=self.dropout,
                                  training=self.training)
        return out, final_states


class SimpleRNN(_MultiLayerRNN):
    CELL = SimpleRNNCell


class LSTM(_MultiLayerRNN):
    CELL = LSTMCell


class GRU(_MultiLayerRNN):
    CELL = GRUCell
