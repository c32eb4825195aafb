"""Model adapters — the stage protocol ``HybridEngine`` trains against
(the port of ``paddle_tpu/distributed/model_adapter.py``).

A model family hands the engine

  - ``init``        — the params tree; block params STACKED on a leading
                      ``[num_layers, ...]`` axis under the key "blocks",
                      everything else ("aux" params: embeddings, final
                      norms, heads) at the top level;
  - ``embed``       — inputs → ``[b, s, D]`` activations;
  - ``block``       — one block: ``(bp, x, seed) -> (x, aux_loss)``, the
                      aux loss a fp32 scalar (the MoE load-balance loss;
                      0 for a dense block);
  - ``head_loss``   — activations + labels → ``(sum_loss, count)``;

and the engine owns the loop over layers, remat, the loss head's
chunking and the optimizer.  This slice trains on one GPU, so there is
no ``param_specs`` (the TP/ZeRO layout) and the shared block is the
whole block rather than a tensor-parallel shard of it.  Two families:
``GPTAdapter`` (causal decoder, dense or MoE) and ``BertAdapter``
(bidirectional encoder with an MLM head).
"""
from __future__ import annotations

__all__ = ["ModelAdapter", "GPTAdapter", "BertAdapter"]


class ModelAdapter:
    """Base stage protocol.  The config object exposes num_layers,
    hidden, num_heads, head_dim, ffn_hidden, vocab_size, max_seq_len,
    dropout, dtype/torch_dtype(), remat, seq_parallel, moe_experts,
    tie_embeddings."""

    cfg = None
    causal = True

    def validate(self, engine):
        cfg = self.cfg
        if engine.sep > 1 and (cfg.moe_experts or not self.causal):
            # the JAX engine routes each sep shard on its own (capacity
            # per shard, aux averaged over shards) and runs a
            # bidirectional ring: both are a later slice of the port
            raise NotImplementedError(
                "sep > 1 is ported for causal dense models only; MoE and "
                "bidirectional (BERT) models train at sep = 1")
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

    def transformer_block(self, engine, bp, x, seed):
        """The pre-LN block shared by GPT (causal) and BERT
        (bidirectional) through ``self.causal``: ``gpt_block`` with the
        engine's attention and dropout.  Returns ``(x, aux)``."""
        from ..models.gpt import gpt_block

        causal = self.causal
        return gpt_block(self.cfg, bp, x, dropout_seed=seed,
                         attention=lambda q, k, v: engine._attention(
                             q, k, v, causal=causal),
                         dropout=engine._dropout)


class GPTAdapter(ModelAdapter):
    """The decoder-LM family: tied embedding, causal pre-LN blocks (dense
    or MoE), final LN + tied-vocab CE head.  The JAX adapter's expert
    checks (ep > 1 needs a MoE model whose experts ep divides) have
    nothing to check here: the engine refuses every ep > 1 (expert
    parallelism is the multi-GPU slice)."""

    causal = True

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, generator, device):
        from ..models.gpt import gpt_init

        return gpt_init(self.cfg, generator=generator, device=device)

    def embed(self, engine, aux, tokens):
        return engine._embed_core(aux["wte"], aux["wpe"], tokens)

    def block(self, engine, bp, x, seed):
        return self.transformer_block(engine, bp, x, seed)

    def head_loss(self, engine, aux, x, labels):
        from ..models.gpt import _layer_norm

        x = _layer_norm(x, aux["lnf_g"], aux["lnf_b"])
        return engine.tied_vocab_ce(x, aux["wte"], labels)

    def reference_loss(self, params, tokens, labels):
        from ..models.gpt import gpt_loss

        return gpt_loss(self.cfg, params, tokens, labels)


class BertAdapter(ModelAdapter):
    """Bidirectional encoder with an MLM head: bidirectional attention,
    token-type embeddings with an embedding LN, and the MLM transform
    (dense + GELU + LN) before the tied vocab projection.

    Step inputs: tokens = corrupted input ids, labels = original ids at
    masked positions, -100 elsewhere — the engine's (tokens, labels)
    contract."""

    causal = False

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, generator, device):
        from ..models.bert import bert_init

        return bert_init(self.cfg, generator=generator, device=device)

    def embed(self, engine, aux, tokens):
        from ..models.bert import bert_embed

        return bert_embed(self.cfg, aux, tokens)

    def block(self, engine, bp, x, seed):
        return self.transformer_block(engine, bp, x, seed)

    def head_loss(self, engine, aux, x, labels):
        from ..models.bert import bert_mlm_transform

        x = bert_mlm_transform(self.cfg, aux, x)
        return engine.tied_vocab_ce(x, aux["wte"], labels)

    def reference_loss(self, params, tokens, labels):
        from ..models.bert import bert_loss

        return bert_loss(self.cfg, params, tokens, labels)
