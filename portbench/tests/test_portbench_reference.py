"""The plain references against ``paddle_tpu_torch`` at its ``tiny``
presets, in float32 on the CPU, on the benchmark's own weights: the GPT
decoder's and BERT's loss and gradients, the engine's AdamW update over
three steps, and the GPT forward logits the serving check reads."""
import statistics

import pytest
import torch

from portbench import compare, traffic, weights
from portbench.reference import models, training

from paddle_tpu_torch import distributed
from paddle_tpu_torch.models.bert import BERT_CONFIGS, bert_loss
from paddle_tpu_torch.models.gpt import GPT_CONFIGS, gpt_forward, gpt_loss

OPT = {"lr": 1e-3, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
       "weight_decay": 0.1, "grad_clip": 1.0}


def config(family):
    src = GPT_CONFIGS["tiny"] if family == "gpt" else BERT_CONFIGS["tiny"]
    c = {"family": family, "num_layers": src.num_layers,
         "hidden": src.hidden, "num_heads": src.num_heads,
         "ffn_hidden": src.ffn_hidden, "vocab_size": src.vocab_size,
         "max_seq_len": src.max_seq_len, "optimizer": OPT,
         "dtype": "bfloat16"}
    if family == "bert":
        c["type_vocab_size"] = src.type_vocab_size
    return c, src


def port_config(family):
    import dataclasses

    _, src = config(family)
    return dataclasses.replace(src, dtype="float32", use_flash=False)


def batch(c, kind, seed=3):
    t = {"kind": kind, "batch": 2, "seq_len": 32, "id_range": [0, 1000],
         "mask_rate": 0.15, "mask_id": 3}
    return traffic.TrainFeed(t, seed, torch.device("cpu")).next()


def tree32(c, seed=11):
    return weights.tree_map(lambda t: t.float(),
                            weights.make(c, seed, torch.device("cpu")))


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_loss_and_gradients_match_the_port(family):
    c, _ = config(family)
    kind = "lm" if family == "gpt" else "mlm"
    tokens, labels = batch(c, kind)
    tree = weights.tree_map(lambda t: t.requires_grad_(True), tree32(c))
    flat = dict(weights.leaves(tree))
    port = (gpt_loss if family == "gpt" else bert_loss)(
        port_config(family), tree, tokens, labels)
    g_port = torch.autograd.grad(port, list(flat.values()))
    ref = models.ce_sum(c, flat, tokens, labels) / (labels != -100).sum()
    g_ref = torch.autograd.grad(ref, list(flat.values()))
    assert float(ref.detach()) == pytest.approx(float(port.detach()), rel=1e-5)
    for p, a, b in zip(flat, g_ref, g_port):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6), p


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_three_steps_follow_the_engine(family):
    c, _ = config(family)
    kind = "lm" if family == "gpt" else "mlm"
    cfg = port_config(family)
    model = cfg if family == "gpt" else distributed.BertAdapter(cfg)
    eng = distributed.HybridEngine(
        model, engine_cfg=distributed.EngineConfig(**OPT),
        device="cpu")
    params = tree32(c)
    opt = eng.init_opt(params)
    batches = [batch(c, kind, seed) for seed in (1, 2, 3)]
    losses = []
    for tokens, labels in batches:
        params, opt, loss = eng.step(params, opt, tokens, labels)
        losses.append(float(loss))
    ref = training.follow(c, dict(weights.leaves(tree32(c))), batches,
                          rows_per_block=1)
    assert ref["loss"] == pytest.approx(losses, rel=1e-5)
    # elements the rounding alone moves (the key bias under softmax) are
    # left out, by compare.py's rule
    rms = statistics.median(float(g.square().mean().sqrt())
                            for g in ref["grad1"].values())
    start = dict(weights.leaves(tree32(c)))
    for p, t in weights.leaves(params):
        keep = ref["grad1"][p].abs() >= compare.ROUNDING_ONLY * rms
        assert keep.any(), p
        assert torch.allclose(ref["change"][p][keep],
                              (t.detach() - start[p])[keep],
                              rtol=1e-3, atol=1e-6), p


def test_gpt_logits_match_the_port():
    c, _ = config("gpt")
    tree = tree32(c)
    tokens = torch.randint(0, 1000, (40,), generator=torch.Generator()
                           .manual_seed(0))
    pos = torch.tensor([0, 7, 39])
    ref = models.gpt_logits_at(c, dict(weights.leaves(tree)), tokens, pos)
    port = gpt_forward(port_config("gpt"), tree, tokens[None])[0, pos]
    assert torch.allclose(ref, port, rtol=1e-4, atol=1e-5)
