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

  - ``param_specs`` — the layout of every leaf over the engine's axes
                      (``mesh.PartitionSpec``s, the JAX adapter's);

and the engine owns the loop over layers, remat, the loss head's
chunking, the collectives and the optimizer.  In one process the block
is ``gpt_block`` with the engine's attention, dropout and MoE hooks; in
a world it is ``tp_transformer_block``, Megatron's split of the same
block over the mp group.  Two families: ``GPTAdapter`` (causal decoder,
dense or MoE) and ``BertAdapter`` (bidirectional encoder with an MLM
head).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .mesh import P

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
        for name, dim in (("hidden", cfg.hidden),
                          ("ffn_hidden", cfg.ffn_hidden),
                          ("num_heads", cfg.num_heads),
                          ("vocab_size", cfg.vocab_size)):
            if dim % engine.mp:
                raise ValueError(f"{name} {dim} must divide mp {engine.mp}")
        if cfg.num_layers % engine.pp:
            raise ValueError(f"num_layers {cfg.num_layers} must divide pp "
                             f"{engine.pp}: a pp rank holds L/pp layers")
        if engine.sep > 1 and cfg.seq_parallel == "ring" and \
                not self.causal:
            raise ValueError(
                "the ring is causal-only (as the JAX ring): train a "
                "bidirectional model at sep > 1 with seq_parallel="
                "'ulysses'")
        if engine.sep > 1 and cfg.seq_parallel == "ulysses":
            if (cfg.num_heads // engine.mp) % engine.sep:
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
        engine's attention, dropout and MoE in one process, the
        tensor-parallel block in a world.  Returns ``(x, aux)``."""
        if engine.distributed:
            return self.tp_transformer_block(engine, bp, x, seed)
        from ..models.gpt import gpt_block

        causal = self.causal
        return gpt_block(self.cfg, bp, x, dropout_seed=seed,
                         attention=lambda q, k, v: engine._attention(
                             q, k, v, causal=causal),
                         dropout=engine._dropout,
                         moe=lambda cfg, bp, h: engine._moe(bp, h))

    def tp_transformer_block(self, engine, bp, x, seed):
        """Megatron's split of the block over the mp group: qkv and up
        column-split (whole heads a rank; the input's gradient summed
        over mp), proj and down row-split with their partial products
        all-reduced before the (replicated) bias — two all-reduces a
        block.  At mp = 1 it is ``gpt_block``'s math.  Dropout seeds fold
        as ``gpt_block``'s."""
        from ..models.gpt import _fold, _layer_norm
        from .mp_layers import copy_to_group, reduce_from_group

        cfg = self.cfg
        mp = engine._live_group("mp")
        B, s, D = x.shape
        hd = cfg.head_dim
        H_local = cfg.num_heads // engine.mp
        s_attn = s_ffn = None
        if seed is not None and cfg.dropout > 0.0:
            s_attn, s_ffn = _fold(seed, 1), _fold(seed, 2)

        h = copy_to_group(_layer_norm(x, bp["ln1_g"], bp["ln1_b"]), mp)
        qkv = (h @ bp["qkv_w"] + bp["qkv_b"]).view(B, s, H_local, 3, hd)
        q = qkv[:, :, :, 0].transpose(1, 2)
        k = qkv[:, :, :, 1].transpose(1, 2)
        v = qkv[:, :, :, 2].transpose(1, 2)
        attn = engine._attention(q, k, v, causal=self.causal)
        attn = attn.transpose(1, 2).reshape(B, s, H_local * hd)
        proj = reduce_from_group(attn @ bp["proj_w"], mp) + bp["proj_b"]
        x = x + engine._dropout(proj, cfg.dropout, s_attn)

        h = _layer_norm(x, bp["ln2_g"], bp["ln2_b"])
        if getattr(cfg, "moe_experts", 0):
            y, aux = engine._moe(bp, h)
            return x + engine._dropout(y, cfg.dropout, s_ffn), aux
        h = copy_to_group(h, mp)
        h = F.gelu(h @ bp["up_w"] + bp["up_b"], approximate="tanh")
        down = reduce_from_group(h @ bp["down_w"], mp) + bp["down_b"]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + engine._dropout(down, cfg.dropout, s_ffn), aux

    def block_specs(self, z=None):
        """Specs of the shared block layout (dense FFN)."""
        return {
            "ln1_g": P("pp", None), "ln1_b": P("pp", None),
            "qkv_w": P("pp", z, "mp"), "qkv_b": P("pp", "mp"),
            "proj_w": P("pp", "mp", z), "proj_b": P("pp", None),
            "ln2_g": P("pp", None), "ln2_b": P("pp", None),
            "up_w": P("pp", z, "mp"), "up_b": P("pp", "mp"),
            "down_w": P("pp", "mp", z), "down_b": P("pp", None),
        }

    def param_specs(self, engine):
        raise NotImplementedError

    @staticmethod
    def _z(engine):
        """ZeRO-3's split of a matrix leaf's free dim: ``"sharding"`` at
        ``zero_stage >= 3`` and sharding > 1 (the JAX adapters' ``z``)."""
        return ("sharding" if engine.ec.zero_stage >= 3 and engine.zr > 1
                else None)


class GPTAdapter(ModelAdapter):
    """The decoder-LM family: vocab-split tied embedding, causal pre-LN
    blocks (dense or MoE), final LN + tied-vocab CE head."""

    causal = True

    def __init__(self, cfg):
        self.cfg = cfg

    def validate(self, engine):
        super().validate(engine)
        cfg = self.cfg
        if engine.ep > 1 and not cfg.moe_experts:
            raise ValueError("ep > 1 needs a MoE model")
        if cfg.moe_experts and cfg.moe_experts % engine.ep:
            raise ValueError(f"experts {cfg.moe_experts} must divide ep "
                             f"{engine.ep}")

    def param_specs(self, engine):
        z = self._z(engine)
        blocks = self.block_specs(z)
        if self.cfg.moe_experts:
            for k in ("up_w", "up_b", "down_w", "down_b"):
                blocks.pop(k)
            # Mixtral-style EP: experts split over "ep", each expert's
            # FFN whole (ep takes mp's role)
            blocks.update({
                "gate_w": P("pp", None, None),
                "up_w": P("pp", "ep", z, None), "up_b": P("pp", "ep", None),
                "down_w": P("pp", "ep", z, None),
                "down_b": P("pp", "ep", None),
            })
        return {"wte": P("mp", z), "wpe": P(None, None),
                "blocks": blocks, "lnf_g": P(None), "lnf_b": P(None)}

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

    def param_specs(self, engine):
        z = self._z(engine)
        return {
            "wte": P("mp", z), "wpe": P(None, None),
            "wtt": P(None, None),
            "emb_ln_g": P(None), "emb_ln_b": P(None),
            "blocks": self.block_specs(z),
            # the MLM transform stays whole on every mp rank (a D x D
            # dense beside the blocks; the tied head needs D whole)
            "mlm_w": P(z, None), "mlm_b": P(None),
            "mlm_ln_g": P(None), "mlm_ln_b": P(None),
        }

    def embed(self, engine, aux, tokens):
        from ..models.bert import bert_embed

        return bert_embed(self.cfg, aux, tokens, engine=engine)

    def block(self, engine, bp, x, seed):
        return self.transformer_block(engine, bp, x, seed)

    def head_loss(self, engine, aux, x, labels):
        from ..models.bert import bert_mlm_transform

        x = bert_mlm_transform(self.cfg, aux, x)
        return engine.tied_vocab_ce(x, aux["wte"], labels)

    def reference_loss(self, params, tokens, labels):
        from ..models.bert import bert_loss

        return bert_loss(self.cfg, params, tokens, labels)
