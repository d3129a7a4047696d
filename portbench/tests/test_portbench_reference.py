"""The plain reference against the program at tiny sizes on the CPU, and
the check: sound runs come out correct, the lower-precision control and
each fault the cells can have come out not correct."""

import numpy as np
import pytest
import torch

from portbench import planted
from portbench.lib import data, harness, registry
from portbench.reference import encoder as ref_encoder
from portbench.reference import kernel as ref_kernel
from portbench.tests import cells


def synth6_lines(n=600):
    cell = registry.load_cell(cells.SERVE)
    lines = data.read_lines(registry.ROOT, cell.config["queries"])
    return cell.config, data.split_order(lines, 10)[:n]


@pytest.mark.parametrize("chunk_norm", [False, True])
def test_encoder_copy_matches_the_program(chunk_norm):
    from nngp_tpu_torch.data.workload import schema_stats
    from nngp_tpu_torch.featurize.join import MultiJoinEncoder

    config, lines = synth6_lines()
    stats_dir = data.checked_dir(registry.ROOT, config["stats"])
    prog = MultiJoinEncoder(schema_stats("synth6", stats_dir),
                            chunk_norm=chunk_norm)
    ref = ref_encoder.MultiJoinEncoder(ref_encoder.load_stats(stats_dir),
                                       chunk_norm=chunk_norm)
    queries = [prog.parse_line(l)[:3] for l in lines]
    want = prog.encode_batch(queries, dtype=np.float64)
    got, y = ref.encode(lines, with_card=True)
    np.testing.assert_array_equal(got, want)
    cards = [prog.parse_line(l)[3] for l in lines]
    np.testing.assert_array_equal(y, np.log2(np.asarray(cards, float)))
    unlabeled, _ = ref.encode([data.strip_card(l) for l in lines])
    np.testing.assert_array_equal(unlabeled, want)


def test_kernel_matches_the_program():
    from nngp_tpu_torch.models.kernel_spec import kernel_eval, \
        reference_kernel

    g = torch.Generator().manual_seed(0)
    x1 = torch.rand((37, 61), generator=g, dtype=torch.float64) * 1000
    x2 = torch.rand((23, 61), generator=g, dtype=torch.float64) * 1000
    layers = [["dense", 512, 1.0, 0.0], ["relu"], ["dense", 1, 1.0, 0.0]]
    want = kernel_eval(reference_kernel().layers, x1, x2)
    torch.testing.assert_close(ref_kernel.cross(layers, x1, x2), want,
                               rtol=1e-12, atol=0)
    torch.testing.assert_close(ref_kernel.diag(layers, x1),
                               torch.diagonal(kernel_eval(
                                   reference_kernel().layers, x1, x1)),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("workload", [cells.SERVE, cells.REFIT])
def test_a_sound_run_is_correct(workload, tmp_path):
    res = cells.run(workload, tmp_path)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0


def test_the_control_is_not_correct(tmp_path):
    """Each cell's lower-precision control, at the tiny size."""
    for workload in (cells.SERVE, cells.REFIT):
        cell = registry.load_cell(workload)
        over, program = harness.runner_for(cell).control(cell.config)
        res = cells.run(workload, tmp_path, program=program, config=over)
        assert not res["correct"], (workload, res["check"])


def test_an_altered_answer_is_not_correct(tmp_path):
    res = cells.run(cells.SERVE, tmp_path, program=planted.altered_answer)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("fault", ["stale_fit", "half_window", "beta_off",
                                   "b_panel"])
def test_a_fault_in_the_fit_is_not_correct(fault, tmp_path):
    res = cells.run(cells.REFIT, tmp_path, program=getattr(planted, fault))
    assert not res["correct"], res["check"]
