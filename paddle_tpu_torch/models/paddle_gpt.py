"""A GPT written the way a Paddle user writes one: only against the top
level of the package it is given (``paddle.to_tensor``, ``paddle.nn``
layers, ``paddle.reshape``/``transpose``/``split``/``matmul``/``arange``,
``nn.functional.scaled_dot_product_attention``, ``gelu`` and
``cross_entropy``, ``paddle.optimizer.AdamW``, ``paddle.amp.auto_cast``).

Every function takes the package as its first argument: ``paddle_tpu``
(the JAX package) or ``paddle_tpu_torch`` (the port), so one program runs
on both and on the card.  This file imports neither (and no JAX): the
CPU test (``tests/test_torch_paddle_program.py``) and ``chip_smoke.py``
phase 20 (b) pass the package in.

The model is ``models/gpt.py``'s pre-LN decoder, dense: embeddings tied
to the output, the qkv columns head-major (``[H, 3, hd]``), causal
attention, tanh GELU, cross entropy over the next token with the last
position ignored (-100), so ``gpt_state_from_params`` carries a
``gpt_init`` tree in and the loss is ``gpt_loss``'s (without dropout).

``dropout > 0`` adds residual dropout after ``proj`` and after ``down``
in each block.  ``recompute=True`` runs each block as
``paddle.distributed.recompute.recompute(block, x)``, the way Paddle
programs write activation checkpointing.  Recompute draws one seed from
the stream a block and replays the block's masks from it
(``core.random.key_stream``); with dropout, a block without recompute
draws its masks the same way, so switching recompute on changes the
memory the step holds and not the function it computes.  Inside a
captured step (hapi's ``train_batch``) both draw from the block's
generator pair of the step scope instead, with fresh masks each step.
"""
from __future__ import annotations

__all__ = ["build_gpt", "gpt_state_from_params", "next_token_labels",
           "loss_fn", "train"]


def build_gpt(paddle, vocab, hidden, heads, ffn, layers, max_seq,
              dropout=0.0, recompute=False, policy="full"):
    """The model, a ``paddle.nn.Layer`` of the given package; ``policy``
    is the recompute's remat policy."""
    import importlib

    nn = paddle.nn
    F = nn.functional
    hd = hidden // heads
    rng = importlib.import_module(paddle.__name__ + ".core.random")
    recompute_fn = importlib.import_module(
        paddle.__name__ + ".distributed.recompute").recompute

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(hidden)
            self.qkv = nn.Linear(hidden, 3 * hidden)
            self.proj = nn.Linear(hidden, hidden)
            self.ln2 = nn.LayerNorm(hidden)
            self.up = nn.Linear(hidden, ffn)
            self.down = nn.Linear(ffn, hidden)
            self.drop = nn.Dropout(dropout) if dropout else None

        def residual(self, y):
            return y if self.drop is None else self.drop(y)

        def forward(self, x):
            b, s = x.shape[0], x.shape[1]
            qkv = paddle.reshape(self.qkv(self.ln1(x)), [b, s, heads, 3, hd])
            q, k, v = [paddle.transpose(paddle.reshape(t, [b, s, heads, hd]),
                                        [0, 2, 1, 3])
                       for t in paddle.split(qkv, 3, axis=3)]
            a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            a = paddle.reshape(paddle.transpose(a, [0, 2, 1, 3]),
                               [b, s, hidden])
            x = x + self.residual(self.proj(a))
            return x + self.residual(self.down(F.gelu(self.up(self.ln2(x)),
                                                      approximate=True)))

    class GPT(nn.Layer):
        def __init__(self):
            super().__init__()
            self.wte = nn.Embedding(vocab, hidden)
            self.wpe = nn.Embedding(max_seq, hidden)
            self.blocks = nn.LayerList([Block() for _ in range(layers)])
            self.lnf = nn.LayerNorm(hidden)

        def forward(self, tokens):
            pos = paddle.arange(tokens.shape[1])
            x = self.wte(tokens) + self.wpe(pos)
            for block in self.blocks:
                if recompute:
                    x = recompute_fn(block, x, policy=policy)
                elif dropout:
                    with rng.key_stream(rng.split_key()):
                        x = block(x)
                else:
                    x = block(x)
            return paddle.matmul(self.lnf(x), self.wte.weight,
                                 transpose_y=True)

    return GPT()


_BLOCK_KEYS = {"ln1.weight": "ln1_g", "ln1.bias": "ln1_b",
               "qkv.weight": "qkv_w", "qkv.bias": "qkv_b",
               "proj.weight": "proj_w", "proj.bias": "proj_b",
               "ln2.weight": "ln2_g", "ln2.bias": "ln2_b",
               "up.weight": "up_w", "up.bias": "up_b",
               "down.weight": "down_w", "down.bias": "down_b"}


def gpt_state_from_params(params, layers):
    """The model's ``state_dict`` names for a ``gpt_init`` tree (stacked
    block leaves, numpy arrays or tensors): ``{name: leaf}``."""
    out = {"wte.weight": params["wte"], "wpe.weight": params["wpe"],
           "lnf.weight": params["lnf_g"], "lnf.bias": params["lnf_b"]}
    for i in range(layers):
        for name, key in _BLOCK_KEYS.items():
            out[f"blocks.{i}.{name}"] = params["blocks"][key][i]
    return out


def next_token_labels(tokens):
    """``gpt_loss``'s labels as numpy: the next token, -100 at the end."""
    import numpy as np

    labels = np.full_like(tokens, -100)
    labels[:, :-1] = tokens[:, 1:]
    return labels


def loss_fn(paddle, model, tokens, labels):
    """Mean next-token cross entropy over the counted positions."""
    logits = model(tokens)
    vocab = logits.shape[-1]
    return paddle.nn.functional.cross_entropy(
        paddle.reshape(logits, [-1, vocab]), paddle.reshape(labels, [-1]),
        ignore_index=-100)


def train(paddle, model, tokens, labels, steps, lr=1e-3, amp_dtype=None):
    """``steps`` AdamW steps on one batch (numpy ``tokens``/``labels``);
    returns the loss before each step.  ``amp_dtype`` runs the forward
    and backward under ``paddle.amp.auto_cast(dtype=amp_dtype)``."""
    import contextlib

    opt = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                 parameters=model.parameters())
    x, y = paddle.to_tensor(tokens), paddle.to_tensor(labels)
    losses = []
    for _ in range(steps):
        ctx = (paddle.amp.auto_cast(dtype=amp_dtype) if amp_dtype
               else contextlib.nullcontext())
        with ctx:
            loss = loss_fn(paddle, model, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses
