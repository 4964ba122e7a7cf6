"""On the card, at the cells' own sizes: each cell's run comes out correct
and its control, the program's float32 path in its place, does not, on
three seeds. Skips without a card."""

import pytest

from benchmark import harness

SPEC = harness.load_spec(held=True)
CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_and_control_on_card(workload, card):
    res = harness.run_cell(SPEC, workload, SEEDS[0], 5.0, False, card)
    assert res["correct"] is True, res["checks"]
    for seed in SEEDS:
        ctl = harness.run_cell(SPEC, workload, seed, 1.0, False, card,
                               variant="float32")
        assert ctl["correct"] is False, ctl["checks"]
