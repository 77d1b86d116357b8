"""On the card: each cell's control comes out not correct where the
program comes out correct, at the cell's own configuration, load and
window, on three seeds. The control is the plain reference one precision
down (bfloat16 inputs and outputs), held to the reference on the run's
own sampled captures; its numbers are printed beside the program's.

    python -m pytest slam_bench/tests/test_card.py -m cuda -s -q

Skips where no card is present.
"""

import json

import pytest
import torch

from slam_bench import registry, run

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    run.environment()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cuda, cell, seed):
    seconds = registry.benchmark()["run_seconds"]
    result = run.measure(cell, seed, seconds, False, control=True)
    program = {n: c["value"] for n, c in result["compared"].items()}
    print(json.dumps({"cell": cell, "seed": seed, "program": program,
                      "control": result["control"], "sample": result["sample"]}))
    assert result["correct"], program
    assert not result["control"]["correct"], result["control"]
