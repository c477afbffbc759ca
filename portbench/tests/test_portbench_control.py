"""The control at a cell's own size, on the card: the reference put in the
program's place in the next precision down (int8 trunk, TF32 float32
layers and Sinkhorn) fails the cell's limits, while the program on the
same seed meets them.  ``python -m pytest portbench/tests -m card`` on a
machine with a card; the limits' readings are in PERF.md."""

import pytest

from conftest import small_context
from portbench import control
from portbench.harness import common

CELLS = ["cnn-train-append-still-4096", "lstm-train-append-still-4096",
         "cnn-eval-prune-spawn"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    tr = common.load_json(f"portbench/traffic/"
                          f"{common.find(common.load_bench()['workloads'], cell, 'w')['traffic']}.json")
    ctx = small_context(cell, seed=2**31 + 99, place=str(card), **tr)
    read = (control.eval_readings if tr["entry"] == "eval"
            else control.train_readings)
    out = read(ctx, True)
    limits = common.load_json(f"portbench/limits/{cell}.json")

    def passes(r):
        return all(r[k] <= limits[k] for k in limits)
    assert passes(out["program"]), out
    assert not passes(out["control"]), out
