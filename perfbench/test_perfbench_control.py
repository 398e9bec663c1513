"""The control on the card: at each cell's own size, on three seeds, the
plain reference at the precision below the configuration's (fp8 for the
bf16 cells, TF32 for the float32 training step), put in the
program's place, must fail one of the cell's limits, while the program
passes all of them.  Windows of 8 s return as many masks as a run of the
served cells samples.  Needs the card; run there with

    python -m pytest perfbench/test_perfbench_control.py -m cuda -q
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_and_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their own size")
    from perfbench import calibrate, harness

    limits = harness.load_json("workloads", cell)["checks"]
    for seed in SEEDS:
        r = calibrate.readings(cell, seed, 8.0, True)
        assert all(r["program"][k] <= v["limit"] for k, v in limits.items()
                   ), (seed, r["program"])
        assert any(r["control"][k] > v["limit"] for k, v in limits.items()
                   ), (seed, r["control"])
