"""Back-to-back refits of the configuration's tier on a rolling window of
an encoded query log, beside the one live posterior a server keeps
serving while it relearns.

The log, its encoding, the window and the timing of a fit are those of
`rolling_refit` (this runner is its subclass). What differs is what a run
holds: one live posterior at a time. A finished fit replaces it, and the
one it replaces is then dropped, so the device holds the live posterior
beside the fit in flight and never a third. The warm fit of the set-up
(start 0) is the first live one. The window starts are a seeded
permutation of every other start, none repeated. A fit that fails (a
factor that is not positive definite: the fp32 control's) is counted and
logged, and leaves the live posterior as it was.

End-to-end reading: refit_ms, from the window's start to the end of the
last fit started in it, over the fits started in it.

The check: the posterior live at the window's end, the last fit the
timed path produced at the timed size, judged by the tier (`judge_fit`)
at a seeded sample of the log's rows against the tier's reference fitted
in fp64 on the same window, every row encoded again by the reference's
own encoder. The runner hands the tier its posterior in a list and keeps
no reference to it, so that the tier can free it before it builds the
reference. With no live posterior (every fit failed) every reading is
infinite.

With --trace 1 the program's own spans (`utils/profiling.py::span`) are
recorded over the traced step and added to the runner's spans: the idle
gaps are then named by the program's innermost span.
"""

import time
from types import SimpleNamespace

import numpy as np

from portbench.lib import data, registry
from portbench.lib.devtrace import Spans, traced_step
from portbench.reference import encoder as ref_encoder

_base = registry.kind("rolling_refit")
control = _base.control


class Runner(_base.Runner):
    def setup(self):
        import torch

        cfg, run = self.cfg, self.run
        self.lines = data.split_order(data.read_lines(run.root,
                                                      cfg["queries"]),
                                      cfg["split_seed"])[:cfg["log_rows"]]
        self.width = cfg["window_rows"]
        # starts[0] = 0 is the warm fit's; the window's follow it
        others = np.arange(1, len(self.lines) - self.width + 1)
        self.starts = np.concatenate([[0], np.random.default_rng(
            [run.seed, 1]).permutation(others)])
        self.spans = Spans() if run.trace else None
        self.fit = (run.program(self) if run.program is not None
                    else self.program_fit())
        self.x, self.y = self._encode()
        self.live = self.live_start = None
        self.failed = 0
        self._live_fit(0)
        if run.device.type == "cuda":
            torch.cuda.synchronize()

    def _live_fit(self, i, session=None):
        """Fit the window of starts[i] beside the live posterior and make
        it the live one; a fit that raises is counted and logged."""
        try:
            start, post = self._one(i, session)
        except Exception as e:               # a fit that never comes
            self.failed += 1
            self.run.log(f"fit {i} failed: {e!r}")
            return
        self.live, self.live_start = post, start

    def _traced(self, at, fits):
        """The traced step: one untraced warm fit, then `fits` fits under
        the profiler and the program's span recorder."""
        import torch
        from nngp_tpu_torch.utils import profiling

        recorded = []

        def warm(session):
            self._live_fit(at, session)

        def step(session):
            profiling.take()
            profiling.enable()
            try:
                for j in range(fits):
                    self._live_fit(at + 1 + j, session)
            finally:
                profiling.disable()
                recorded[:] = profiling.take()[0]

        traced = traced_step(torch, warm, step, self.run.tmp_dir)
        for s in recorded:
            self.spans.add(s.name, s.t0, s.t1, **s.attrs)
        return traced, len(recorded)

    def window(self, seconds):
        i, traced, traced_fits, program_spans = 1, None, 0, 0
        self.failed, self.fit_s = 0, []
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while time.perf_counter() < t_end and i < len(self.starts):
            if (self.run.trace and traced is None
                    and time.perf_counter() >= t0 + 0.3 * seconds):
                traced_fits = self.mix["traced_fits"]
                traced, program_spans = self._traced(i, traced_fits)
                i += 1 + traced_fits
                continue
            self._live_fit(i)
            i += 1
        elapsed = time.perf_counter() - t0
        fits = i - 1
        blocks = getattr(getattr(self.live, "l", None), "starts", (0,))
        counts = {"fits": fits, "fits_failed": self.failed,
                  "traced_fits": traced_fits,
                  "window_rows": self.width,
                  "feature_dim": int(self.x.shape[1]),
                  "blocks": len(blocks) - 1,
                  "block_columns": blocks[1] if len(blocks) > 1 else 0,
                  "program_spans": program_spans,
                  "checked_start": self.live_start,
                  "fit_ms_p5_p50_p95": [
                      float(np.percentile(self.fit_s, q)) * 1e3
                      for q in (5, 50, 95)] if self.fit_s else []}
        return SimpleNamespace(
            e2e={"refit_ms": elapsed * 1e3 / max(fits, 1)}, counts=counts,
            spans=self.spans, traced=traced,
            attempted=fits, failed=self.failed)

    def judge(self):
        """The live posterior judged by the tier at a seeded sample of the
        log's rows (module docstring)."""
        import torch

        cfg, run = self.cfg, self.run
        if self.live is None:
            run.log("no live posterior to judge: every fit failed")
            return dict.fromkeys(cfg["limits"], float("inf"))
        dev, f64 = run.device, torch.float64
        rng = np.random.default_rng([run.seed, 3])
        probe = rng.choice(len(self.lines), size=cfg["check_rows"],
                           replace=False)
        window = range(self.live_start, self.live_start + self.width)
        need = sorted({int(p) for p in probe}.union(window))
        at = {r: k for k, r in enumerate(need)}
        enc = ref_encoder.MultiJoinEncoder(
            ref_encoder.load_stats(data.checked_dir(run.root, cfg["stats"])),
            chunk_norm=cfg["chunk_norm"])
        x, y = enc.encode([self.lines[r] for r in need], with_card=True)
        x = torch.as_tensor(x, dtype=f64, device=dev)
        y = torch.as_tensor(y, dtype=f64, device=dev)
        xp = x[torch.as_tensor([at[int(p)] for p in probe], device=dev)]
        rows = torch.as_tensor([at[r] for r in window], device=dev)
        held, self.live = [self.live], None
        return self.tier.judge_fit(cfg, held, x[rows], y[rows], xp)
