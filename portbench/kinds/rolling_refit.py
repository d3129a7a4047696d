"""Back-to-back refits of the configuration's tier on a rolling window of
an encoded query log.

The log: the configuration's labeled lines in the order of the split
(`split_seed`), encoded once at set-up by the program's native encoder as
`serve.Estimator` encodes labeled lines (the chunk_norm scale applied),
in the configuration's dtype. Each fit is the tier's (`tiers/<tier>.py`) on
`window_rows` consecutive rows of it, host numpy input as
`Estimator._fit` passes it, and ends when the posterior is ready. The
window starts are a seeded permutation of every start but 0, which the
warm fit of the set-up takes; no two fits of a run share a start, so none
finds its inducing bases cached.

End-to-end reading: refit_ms, from the window's start to the end of the
last fit started in it, over the fits started in it.

The control (`control`): the configuration's `control`, either `config`
keys to run the program with (its own path in the next precision down)
or `reference` options of the tier's reference fit put in the program's
place.
"""

import time
from types import SimpleNamespace

import numpy as np

from portbench.lib import data, registry
from portbench.lib.devtrace import Spans, traced_step
from portbench.reference import encoder as ref_encoder

KEEP = 2        # fits the reservoir keeps for the check


class Runner:
    IDLE_OUTSIDE = "between_fits"

    def __init__(self, run):
        self.run = run
        self.cfg, self.mix = run.config, run.mix
        self.tier = registry.tier(run.config["tier"], run.root)
        self.fit_s = []

    def setup(self):
        import torch

        cfg, run = self.cfg, self.run
        self.lines = data.split_order(data.read_lines(run.root,
                                                      cfg["queries"]),
                                      cfg["split_seed"])
        self.lines = self.lines[:cfg["log_rows"]]
        self.width = cfg["window_rows"]
        starts = np.arange(1, len(self.lines) - self.width + 1)
        self.starts = np.random.default_rng([run.seed, 1]).permutation(
            starts)
        self.spans = Spans() if run.trace else None
        if run.program is not None:
            self.fit = run.program(self)
        else:
            self.fit = self.program_fit()
        self.x, self.y = self._encode()
        self.fit(self.x[:self.width], self.y[:self.width])
        if run.device.type == "cuda":
            torch.cuda.synchronize()

    def _encode(self):
        from nngp_tpu_torch.data.workload import schema_stats
        from nngp_tpu_torch.featurize.join import MultiJoinEncoder
        from nngp_tpu_torch.native import FastEncoder

        cfg, run = self.cfg, self.run
        dtype = np.dtype(cfg["dtype"])
        stats = schema_stats(cfg["schema"],
                             data.checked_dir(run.root, cfg["stats"]))
        x, cards, *_ = FastEncoder(stats).encode_multi(
            "\n".join(self.lines), with_card=True, dtype=dtype)
        if cfg["chunk_norm"]:
            x = x * MultiJoinEncoder(stats, chunk_norm=True
                                     ).col_scale.astype(dtype)
        return x, np.log2(cards).reshape(-1, 1).astype(dtype)

    def program_fit(self):
        """The system under test: the tier's fit on this run's device."""
        return self.tier.fit(self.cfg, self.run.device)

    def _one(self, i, session=None):
        import torch

        if session is not None:
            session.mark()
        start = int(self.starts[i])
        t0 = time.perf_counter()
        xw = self.x[start:start + self.width]
        yw = self.y[start:start + self.width]
        t1 = time.perf_counter()
        post = self.fit(xw, yw)
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        self.fit_s.append(t2 - t1)
        if self.spans is not None:
            self.spans.add("window_slice", t0, t1)
            self.spans.add("fit", t1, t2)
        return start, post

    def window(self, seconds):
        import torch

        rng = np.random.default_rng([self.run.seed, 2])
        kept, i, traced, traced_fits = [], 0, None, 0
        failed, self.fit_s = 0, []
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while time.perf_counter() < t_end and i < len(self.starts):
            if (self.run.trace and traced is None
                    and time.perf_counter() >= t0 + 0.3 * seconds):
                traced_fits = self.mix["traced_fits"]
                at = i

                def warm(session):
                    self._one(at, session)

                def step(session):
                    for j in range(traced_fits):
                        self._one(at + 1 + j, session)
                traced = traced_step(torch, warm, step, self.run.tmp_dir)
                i += 1 + traced_fits
                continue
            try:
                start, post = self._one(i)
            except Exception as e:               # a fit that never comes
                failed += 1
                self.run.log(f"fit {i} failed: {e!r}")
                i += 1
                continue
            # a reservoir of KEEP fits, uniform over the fits of the window
            if len(kept) < KEEP:
                kept.append((start, post))
            else:
                j = int(rng.integers(0, i + 1))
                if j < KEEP:
                    kept[j] = (start, post)
            i += 1
        elapsed = time.perf_counter() - t0
        self.kept = kept
        starts = self.starts[:i]
        counts = {"fits": i, "fits_failed": failed,
                  "traced_fits": traced_fits,
                  "window_rows": self.width,
                  "feature_dim": int(self.x.shape[1]),
                  "window_start_p5_p50_p95": [
                      float(np.percentile(starts, q)) for q in (5, 50, 95)],
                  "checked_starts": [s for s, _ in kept],
                  # each fit's own time, and their mean in each half of
                  # the window: the drift within a run
                  "fit_ms_p5_p50_p95": [
                      float(np.percentile(self.fit_s, q)) * 1e3
                      for q in (5, 50, 95)] if self.fit_s else [],
                  "fit_ms_mean_halves": [
                      float(np.mean(h)) * 1e3 for h in
                      np.array_split(np.asarray(self.fit_s), 2)
                      if len(h)]}
        return SimpleNamespace(
            e2e={"refit_ms": elapsed * 1e3 / max(i, 1)}, counts=counts,
            spans=self.spans, traced=traced,
            attempted=i, failed=failed)

    def release(self):
        self.fit = None

    def judge(self):
        """Each kept fit judged by the tier (`judge_fit`) at a seeded
        sample of the log's rows, against the tier's reference fitted in
        fp64 on the same window, every row encoded again by the
        reference's own encoder: the worst of each number."""
        import torch

        cfg, run = self.cfg, self.run
        dev, f64 = run.device, torch.float64
        rng = np.random.default_rng([run.seed, 3])
        probe = rng.choice(len(self.lines), size=cfg["check_rows"],
                           replace=False)
        need = sorted({int(p) for p in probe}.union(
            *(range(s, s + self.width) for s, _ in self.kept)))
        at = {r: k for k, r in enumerate(need)}
        enc = ref_encoder.MultiJoinEncoder(
            ref_encoder.load_stats(data.checked_dir(run.root, cfg["stats"])),
            chunk_norm=cfg["chunk_norm"])
        x, y = enc.encode([self.lines[r] for r in need], with_card=True)
        x = torch.as_tensor(x, dtype=f64, device=dev)
        y = torch.as_tensor(y, dtype=f64, device=dev)
        xp = x[torch.as_tensor([at[int(p)] for p in probe], device=dev)]
        worst = {}
        for start, post in self.kept:
            rows = torch.as_tensor([at[r] for r in
                                    range(start, start + self.width)],
                                   device=dev)
            readings = self.tier.judge_fit(cfg, post, x[rows], y[rows], xp)
            for name, value in readings.items():
                worst[name] = max(worst.get(name, 0.0), value)
        return worst


def control(config):
    """(config overrides, program or None): the configuration's control.
    With `reference` options the tier's reference fit, so computed, takes
    the program's place."""
    spec = config["control"]
    if "reference" not in spec:
        return dict(spec.get("config", {})), None
    return dict(spec.get("config", {})), reference_in_place(
        config, **spec["reference"])


def reference_in_place(config, **options):
    """A program factory: the tier's reference fit with `options` (its
    dtype, tf32), host rows moved to the run's device as the program's
    fit moves them."""
    import torch

    if "dtype" in options:
        options["dtype"] = getattr(torch, options["dtype"])

    def program(runner):
        device = runner.run.device
        ref = registry.reference(runner.cfg["tier"], runner.run.root)

        def fit(x, y):
            return ref.fit(runner.cfg, torch.as_tensor(x, device=device),
                           torch.as_tensor(y, device=device), **options)
        return fit
    return program
