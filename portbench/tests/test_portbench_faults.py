"""A run with its timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program, driven through the
rest of a run on the CPU at small sizes (the look for a card skipped),
and judged by the cell's own limits."""
import pytest

from portbench.tests import small

from paddle_tpu_torch.distributed.engine import HybridEngine
from paddle_tpu_torch.serving import engine as serving

TRAIN = ["gpt3-1.3b.train-2k", "bert-base.mlm-512"]
SERVE = ["gpt3-1.3b.serve-chat64", "gpt3-1.3b.serve-unique64"]


def state_unchanged(monkeypatch):
    """The optimizer's update does nothing: the step returns its state."""
    monkeypatch.setattr(HybridEngine, "_apply", lambda self, *a: None)


def half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    loss_grads = HybridEngine._loss_grads

    def half(self, params, paths, leaves, tokens, labels, key):
        b = tokens.shape[0] // 2
        return loss_grads(self, params, paths, leaves, tokens[:b],
                          labels[:b], key)

    monkeypatch.setattr(HybridEngine, "_loss_grads", half)


def pages_unchanged(monkeypatch):
    """The serving step writes no key or value into the paged cache."""
    step = serving.gpt_ragged_step

    def frozen(cfg, params, tokens, rows, slots, qlens, ctxs, k_pages,
               v_pages, tables, **kw):
        return step(cfg, params, tokens, rows, slots, qlens, ctxs,
                    k_pages.clone(), v_pages.clone(), tables, **kw)

    monkeypatch.setattr(serving, "gpt_ragged_step", frozen)


def token_altered(monkeypatch):
    """Every fifth sampled token is replaced by the next id."""
    sample = serving.Engine._sample_token
    calls = [0]

    def altered(self, logits_row, req):
        tok = sample(self, logits_row, req)
        calls[0] += 1
        return (tok + 1) % len(logits_row) if calls[0] % 5 == 0 else tok

    monkeypatch.setattr(serving.Engine, "_sample_token", altered)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
@pytest.mark.parametrize("cell", TRAIN)
def test_training_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = small.run(cell, seconds=0.3)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", [pages_unchanged, token_altered])
@pytest.mark.parametrize("cell", SERVE)
def test_serving_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = small.run(cell, seconds=2.0)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell):
    r = small.run(cell, seconds=2.0 if cell in SERVE else 0.5)
    assert r["correct"] is True, r["checks"]
