"""On the card: the tiny cells through the kernels, sound and control.
`python -m pytest portbench/tests -q -m card` on a machine with a card;
skips without one."""

import pytest

from portbench.lib import harness, registry
from portbench.tests import cells


@pytest.mark.card
@pytest.mark.parametrize("workload", [cells.SERVE, cells.REFIT])
def test_tiny_cells_on_the_card(workload, card, tmp_path):
    res = cells.run(workload, tmp_path, device=card)
    assert res["correct"], res["check"]
    assert res["device"]["kind"] and res["device"]["memory_peak_bytes"] > 0
    cell = registry.load_cell(workload)
    over, program = harness.runner_for(cell).control(cell.config)
    res = cells.run(workload, tmp_path, program=program, config=over,
                    device=card)
    assert not res["correct"], res["check"]
