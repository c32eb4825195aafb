"""The control comes out not correct: the reference computed one
precision below the configuration's (the cell's ``control`` in
``reference/lowp.py``) put in the program's place, at each cell's own
size on the card, judged by the cell's limits.  The faults
the calibration plants (half of a training batch left out; a served
token altered) fail them too.  Skips where there is no CUDA card."""
import json

import pytest
import torch

from portbench import calibrate, compare, harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    entry = harness.cell_entry(harness.benchmark(), cell)
    spec = harness.load_json(harness.HERE, "workloads", f"{cell}.json")
    config = harness.load_json(harness.HERE, "configs",
                               f"{entry['config']}.json")
    ctx = harness.Ctx(cell, spec, config, 3141592653, 20.0, False,
                      torch.device("cuda", 0), 0.0)
    kind = {"train": calibrate.training, "serve": calibrate.serving}
    line = kind[spec["driver"]](ctx, [spec["control"]], calibrate.Flags())
    print(json.dumps(line))
    for name in (spec["control"], "half_batch", "token_altered"):
        if name in line:
            ok, checks = compare.judge(line[name], spec["limits"])
            assert not ok, (name, checks)
