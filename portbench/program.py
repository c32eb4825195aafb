"""The system under test, built from a configuration's file: the only
place the harness names the port's entry points and config classes.
Imported by the drivers, never by the reference."""
from __future__ import annotations


def model_config(c):
    """The port's config object for ``c`` (its published widths)."""
    common = dict(vocab_size=c["vocab_size"], max_seq_len=c["max_seq_len"],
                  hidden=c["hidden"], num_layers=c["num_layers"],
                  num_heads=c["num_heads"], ffn_hidden=c["ffn_hidden"],
                  dropout=c["dropout"], dtype=c["dtype"], remat=c["remat"])
    if c["family"] == "gpt":
        from paddle_tpu_torch.models.gpt import GPTConfig

        return GPTConfig(**common)
    from paddle_tpu_torch.models.bert import BertConfig

    return BertConfig(type_vocab_size=c["type_vocab_size"], **common)


def hybrid_engine(c, cell, device):
    """``HybridEngine`` on one device with the configuration's optimizer
    and the cell's accumulation."""
    from paddle_tpu_torch import distributed

    cfg = model_config(c)
    model = cfg if c["family"] == "gpt" else distributed.BertAdapter(cfg)
    opt = c["optimizer"]
    ec = distributed.EngineConfig(
        lr=opt["lr"], beta1=opt["beta1"], beta2=opt["beta2"], eps=opt["eps"],
        weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
        opt_dtype=c["opt_dtype"], accum_steps=cell["accum_steps"])
    return distributed.HybridEngine(model, engine_cfg=ec, device=device)


def serving_engine(c, cell, params, device):
    """The serving ``Engine`` over ``params`` with the cell's settings."""
    from paddle_tpu_torch.serving import Engine

    return Engine(model_config(c), params, device=device, **cell["engine"])


def sampling(max_new_tokens):
    """Greedy decoding of exactly ``max_new_tokens`` tokens."""
    from paddle_tpu_torch.serving import SamplingParams

    return SamplingParams(max_new_tokens=max_new_tokens, temperature=0.0)
