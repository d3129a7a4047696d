"""`cli/production_serving_demo.py`, the counterpart of
`examples/production_serving_demo.py`, runs every step of the serving
lifecycle to its end on the CPU: fit, checkpoint, restore, warmup, TCP
serving, calibration, conformal intervals, extend, drift, relearn and
feedback over the wire."""

from nngp_tpu_torch.cli import production_serving_demo


def test_production_serving_demo_runs_to_its_end(capsys):
    est = production_serving_demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for step in range(1, 11):
        assert f"[{step}]" in out, step
    assert out.rstrip().endswith("done")
    assert est.posterior.num_train == 422
