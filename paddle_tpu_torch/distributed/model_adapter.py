"""Model adapters — the stage protocol ``HybridEngine`` trains against
(the port of ``paddle_tpu/distributed/model_adapter.py``).

A model family hands the engine

  - ``init``        — the params tree; block params STACKED on a leading
                      ``[num_layers, ...]`` axis under the key "blocks",
                      everything else ("aux" params: embeddings, final
                      norms, heads) at the top level;
  - ``embed``       — inputs → ``[b, s, D]`` activations;
  - ``block``       — one block: ``(bp, x, seed) -> x`` (the MoE aux
                      loss of the JAX protocol comes with the MoE port);
  - ``head_loss``   — activations + labels → ``(sum_loss, count)``;

and the engine owns the loop over layers, remat, the loss head's
chunking and the optimizer.  This slice trains on one GPU, so there is
no ``param_specs`` (the TP/ZeRO layout) and no tensor-parallel block;
``BertAdapter`` is a later slice of the port.
"""
from __future__ import annotations

__all__ = ["ModelAdapter", "GPTAdapter"]


class ModelAdapter:
    """Base stage protocol.  The config object exposes num_layers,
    hidden, num_heads, head_dim, ffn_hidden, vocab_size, max_seq_len,
    dropout, dtype/torch_dtype(), remat, moe_experts, tie_embeddings."""

    cfg = None

    def validate(self, engine):
        cfg = self.cfg
        if cfg.moe_experts:
            raise NotImplementedError(
                "MoE blocks are not ported yet; the port trains dense "
                "models")
        if engine.sep > 1 and cfg.seq_parallel == "ulysses" and \
                (cfg.num_heads // engine.mp) % engine.sep:
            raise ValueError(
                "Ulysses needs local heads divisible by sep (use "
                "seq_parallel='ring' to lift the head cap)")

    def init(self, generator, device):
        raise NotImplementedError

    def embed(self, engine, aux, tokens):
        """aux: the non-"blocks" params.  → ``[b, s, D]``."""
        raise NotImplementedError

    def block(self, engine, bp, x, seed):
        raise NotImplementedError

    def head_loss(self, engine, aux, x, labels):
        raise NotImplementedError

    def decay_this(self, path):
        """Weight-decay mask by param path (reference AdamW apply_decay_
        param_fun): skip norms and biases."""
        leaf = path.split("/")[-1]
        return ("ln" not in leaf) and not path.endswith("_b")

    def reference_loss(self, params, tokens, labels):
        """Single-device loss with the same math — the parity oracle."""
        raise NotImplementedError


class GPTAdapter(ModelAdapter):
    """The decoder-LM family: tied embedding, causal pre-LN blocks,
    final LN + tied-vocab CE head."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, generator, device):
        from ..models.gpt import gpt_init

        return gpt_init(self.cfg, generator=generator, device=device)

    def embed(self, engine, aux, tokens):
        return engine._embed_core(aux["wte"], aux["wpe"], tokens)

    def block(self, engine, bp, x, seed):
        from ..models.gpt import gpt_block

        return gpt_block(self.cfg, bp, x, dropout_seed=seed,
                         attention=engine._attention,
                         dropout=engine._dropout)

    def head_loss(self, engine, aux, x, labels):
        from ..models.gpt import _layer_norm

        x = _layer_norm(x, aux["lnf_g"], aux["lnf_b"])
        return engine.tied_vocab_ce(x, aux["wte"], labels)

    def reference_loss(self, params, tokens, labels):
        from ..models.gpt import gpt_loss

        return gpt_loss(self.cfg, params, tokens, labels)
