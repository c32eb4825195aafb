"""Small sizes for the CPU tests: each cell's configuration and traffic
cut to a size a CPU runs in seconds, its structure unchanged."""
from __future__ import annotations

import torch

#: at these widths the blocks outweigh the embedding in the residual
#: stream, as at the published ones; at hidden 256 a random model mostly
#: repeats its last token whatever the attention reads, and a cache
#: that is never written serves nearly the same tokens
SMALL_MODEL = {"num_layers": 4, "hidden": 512, "num_heads": 8,
               "head_dim": 64, "ffn_hidden": 2048, "vocab_size": 1024}


def shrink(cell, config):
    """``harness.run_cell``'s override: small widths, depth, batches and
    engine, every cell's kind of work kept."""
    config.update(SMALL_MODEL)
    # float32 on the CPU: a sound run reads far below the card's limits,
    # which were set from bfloat16 at the published widths
    config["dtype"] = "float32"
    config["max_seq_len"] = 256 if config["family"] == "gpt" else 128
    t = cell["traffic"]
    t["id_range"] = [0, 1000]
    if cell["driver"] == "train":
        t.update(batch=4, seq_len=64)
        if t["kind"] == "mlm":
            t["mask_id"] = 3
        cell.update(reference_rows=2, trace_steps=2)
    else:
        t.update(clients=4, pool=64, system_len=32, warmup_finished=4,
                 user_len={"median": 32, "sigma": 0.8, "min": 4, "max": 96},
                 output_len={"median": 8, "sigma": 0.7, "min": 4,
                             "max": 24})
        cell["engine"].update(max_batch_size=4, chunk_len=32, page_size=16,
                              num_pages=64)
        cell.update(trace_seconds=0.2, check_requests=2)


def run(name, seed=12345, seconds=1.0, trace=0, override=shrink):
    from portbench import harness

    # the test workers share the CPU: a few threads each keep a window's
    # steps from stalling on one another
    torch.set_num_threads(2)

    return harness.run_cell(name, seed, seconds, trace, torch.device("cpu"),
                            0.0, override=override)
