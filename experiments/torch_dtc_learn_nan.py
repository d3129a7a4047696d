"""Where the batched fp32 DTC learn of synth6_big's best configuration goes
NaN, and which batched op sends it there.

`chip_smoke.py` phase 12 (b) learns with `fit_kernel_hyperparams(x, y,
steps=100, max_points=None, ard=True, objective='dtc', dtc_m=512)` on
phase 8's 90,000-row chunk_norm fp32 split; its three restarts (initial
ridge 1e-3, 3e-2, 0.3) run as one batch. The DTC loss
(`nngp_tpu_torch/gp/hyperopt.py::_nll_dtc`) has five batched
linear-algebra steps, in this order:

  kmm      the K_mm factor, cholesky_ex of (R, m, m);
  psi      solve_triangular(L_mm, K_nm^T), (R, m, n);
  c        C = psi psi^T, a batched GEMM summing n products;
  cfactor  the factor of C + r I;
  t        the solve for t, (R, m, 1).

This runs the same learn once per --arms entry and prints, for each
restart, how many of its 101 loss evaluations (100 steps and the final
one) were not finite, which factor failed first, its final loss, the
winner's log evidence, and restart 0's smallest and largest eigenvalue of
the C + r I its factor gets (fp64 eigvalsh) at every evaluation, with r:

  cuda          the loss as it stands: C and b formed in fp64 from the
                fp32 psi, all restarts in one product, and the m x m
                stage in fp64;
  cuda-fp64-loop  the same, C and b restart by restart;
  cuda-fp32c    C and b in fp32 restart by restart (the loss of PR 10);
  cuda-batched  every step batched in fp32, as the loss ran before PR 10;
  loop-<step>   cuda-batched with that one step run as a Python loop over
                the R = 1 slices (autograd keeps its gradient);
  loop-all      every batched op of the loss so, products included;
  cuda-magma    cuda-batched under preferred_linalg_library('magma');
  cuda-r0       cuda-fp32c with the 1e-3 restart alone (reg_restarts=());
  cpu           cuda-batched on the host (LAPACK), rows and seeds unchanged.

With --time_c it first times C = psi psi^T and b = psi y alone at the
learn's shape (3, 512, 90,000), forward and forward + backward, in fp32
and fp64, batched and restart by restart (CUDA events).

In the first batched arm, at --diagnose (the evaluation where restart 0
first failed on the card), it also prints:
  - every batched op of that evaluation against the same op on restart
    0's slice alone with the same inputs: max |batched - alone| / max
    |batched| (0.0 means bit for bit);
  - restart 0's C in the batch and in restart 0's own R = 1 loss at the
    same theta: the smallest eigenvalue of C + r I (fp64 eigvalsh of the
    fp32 matrix the factor gets), max |C - C^T|, max |C_batch - C_alone| /
    max |C_batch|, and whether each factor fails in the batch and alone;
  - the CUDA kernels each of the two losses launched (torch.profiler),
    which name the routes the ops took.

    python experiments/torch_dtc_learn_nan.py --time_c \\
        --arms cuda,cuda-fp64-loop,cuda-fp32c

The cpu arm takes over 20 minutes on 8 cores; run it where the full
90,000 rows fit in memory (about 10 GiB).
"""

import argparse
import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nngp_tpu_torch.gp import hyperopt  # noqa: E402

STEPS = ("kmm", "psi", "c", "cfactor", "t")
ARMS = (("cuda", "cuda-fp64-loop", "cuda-fp32c", "cuda-batched")
        + tuple(f"loop-{s}" for s in STEPS + ("all",))
        + ("cuda-magma", "cuda-r0", "cpu"))


def _each_restart(fn, t):
    """fn(t[r:r+1]) for each restart r, each output concatenated over the
    restarts: each restart's products are those of its own R = 1 call."""
    outs = [fn(t[r:r + 1]) for r in range(t.shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def c_fp32_batched(psi, ym):
    """C and b in fp32 over all restarts at once (before PR 10)."""
    return psi @ psi.mT, psi @ ym


def c_fp32_loop(psi, ym):
    """C and b in fp32 restart by restart (PR 10's loss)."""
    return _each_restart(lambda p: (p @ p.mT, p @ ym), psi)


c_fp64_batched = hyperopt._c_moments     # the loss's own, as shipped


def c_fp64_loop(psi, ym):
    """The shipped fp64 C and b, restart by restart."""
    return _each_restart(lambda p: c_fp64_batched(p, ym), psi)


# the C and b each arm forms (None: the loss as it stands)
C_MOMENTS = {"cuda": None, "cuda-fp64-loop": c_fp64_loop,
             "cuda-fp32c": c_fp32_loop, "cuda-r0": c_fp32_loop}


def _slice(t, r):
    """Restart r's R = 1 slice of a batched (3-D) argument; a shared one
    as it is."""
    return t[r:r + 1] if t.dim() == 3 else t


def _rel(a, b):
    a, b = a.double(), b.double()
    scale = float(torch.max(torch.abs(a)))
    return float(torch.max(torch.abs(a - b))) / (scale if scale else 1.0)


class Hooks:
    """Wraps the DTC loss, `cholesky_ex`, `solve_triangular` and
    `Tensor.__matmul__` / `torch.matmul` while the learn runs: names each
    call by its step (cholesky_ex calls 0, 1 are kmm, cfactor;
    solve_triangular calls 0, 1 are psi, t; psi times its own transpose
    is c; every other product is "matmul"),
    runs the step `loop` slice by slice, records each evaluation's
    per-restart loss and failed factors, and captures the evaluation
    `diagnose`."""

    def __init__(self, loop=None, diagnose=None):
        self.loop, self.diagnose = loop, diagnose
        self.losses, self.failed, self.margins = [], [], []
        self._loss = hyperopt._nll_dtc
        self._c_factor = hyperopt._c_factor
        self._chol = torch.linalg.cholesky_ex
        self._solve = torch.linalg.solve_triangular
        self._mm = torch.Tensor.__matmul__
        self._matmul = torch.matmul
        self._psi = None             # data_ptr of this evaluation's psi
        self._count = None           # per-evaluation call counters
        self._infos = None
        self.records = None          # (step, fn, args, kw, out) when captured

    def _step(self, kind, args):
        if kind == "mm":
            a, b = args
            c = (a.dim() == 3 and a.data_ptr() == self._psi
                 and b.data_ptr() == a.data_ptr() and b.shape == a.mT.shape
                 and b.stride() == a.mT.stride())
            return "c" if c else "matmul"
        i = self._count[kind]
        self._count[kind] += 1
        names = {"chol": ("kmm", "cfactor"), "solve": ("psi", "t")}[kind]
        return names[i] if i < 2 else kind

    def _run(self, kind, fn, args, kw):
        if self._count is None:            # outside the loss
            return fn(*args, **kw)
        step = self._step(kind, args)
        batch = args[0].dim() == 3 and args[0].shape[0] > 1
        if self.loop in (step, "all") and batch:
            outs = [fn(*(_slice(a, r) for a in args), **kw)
                    for r in range(args[0].shape[0])]
            out = (type(outs[0])(tuple(torch.cat(p) for p in zip(*outs)))
                   if isinstance(outs[0], tuple) else torch.cat(outs))
        else:
            out = fn(*args, **kw)
        if step == "psi":
            self._psi = out.data_ptr()
        if kind == "chol" and self._infos is not None:
            self._infos.append((out.info > 0).reshape(-1).cpu().numpy())
        if self.records is not None and args[0].dim() == 3:
            det = (tuple(o.detach() for o in out) if isinstance(out, tuple)
                   else out.detach())
            self.records.append((step, fn, [a.detach() for a in args], kw,
                                 det))
        return out

    def _eval(self, *args, **kw):
        """One loss evaluation, its step counters from 0."""
        self._count = {"chol": 0, "solve": 0}
        try:
            return self._loss(*args, **kw)
        finally:
            self._count = None

    def __enter__(self):
        hooks = self

        def chol(a, *args, **kw):
            return hooks._run("chol", hooks._chol, (a,) + args, kw)

        def solve(a, b, *args, **kw):
            return hooks._run("solve", hooks._solve, (a, b) + args, kw)

        def mm(a, b):
            return hooks._run("mm", hooks._mm, (a, b), {})

        def matmul(a, b, **kw):
            return hooks._run("mm", hooks._matmul, (a, b), kw)

        def c_factor(c, r):
            a, r0 = c[0].detach().double(), float(r[0].detach())
            lam = torch.linalg.eigvalsh(
                a + r0 * torch.eye(a.shape[0], dtype=a.dtype,
                                   device=a.device))
            hooks.margins.append((float(lam[0]), float(lam[-1]), r0))
            return hooks._c_factor(c, r)

        def loss(*args, **kw):
            ev = len(self.losses)
            capture = ev == self.diagnose
            self._infos = []
            if capture:
                self.records = []
                with _profiled() as prof:
                    val = self._eval(*args, **kw)
                self._diagnose(args, kw, self.records, prof)
                self.records = None
            else:
                val = self._eval(*args, **kw)
            self.losses.append(val.detach().cpu().numpy())
            self.failed.append(np.stack(self._infos[:2]))   # (2, R)
            self._infos = None
            return val

        hyperopt._nll_dtc = loss
        hyperopt._c_factor = c_factor
        torch.linalg.cholesky_ex = chol
        torch.linalg.solve_triangular = solve
        torch.Tensor.__matmul__ = mm
        torch.matmul = matmul
        return self

    def __exit__(self, *exc):
        hyperopt._nll_dtc = self._loss
        hyperopt._c_factor = self._c_factor
        torch.linalg.cholesky_ex = self._chol
        torch.linalg.solve_triangular = self._solve
        torch.Tensor.__matmul__ = self._mm
        torch.matmul = self._matmul

    # ------------------------------------------------------------ diagnose
    def _diagnose(self, args, kw, batched, prof):
        ev = self.diagnose
        print(f"    evaluation {ev}: each batched op against restart 0's "
              "slice alone, same inputs (max|batched - alone| / "
              "max|batched|):")
        for step, fn, a, k, out in batched:
            if a[0].shape[0] < 2:
                continue
            with torch.no_grad():
                alone = fn(*(_slice(t, 0) for t in a), **k)
            if isinstance(out, tuple):
                d = _rel(out[0][:1], alone[0])
                info = (int(out[1].reshape(-1)[0]),
                        int(alone[1].reshape(-1)[0]))
                extra = f", info batch/alone {info}"
            else:
                d, extra = _rel(out[:1], alone), ""
            shapes = " x ".join(str(tuple(t.shape)) for t in a)
            print(f"      {step:8s} {shapes}: {d!r}{extra}")
        theta = {k2: v[:1].detach() for k2, v in args[0].items()}
        self._infos, infos = [], self._infos
        self.records = []
        with torch.no_grad(), _profiled() as prof_alone:
            self._eval(theta, *args[1:], **kw)
        alone, self.records, self._infos = self.records, None, infos
        one = {s: out for s, _, _, _, out in alone}
        many = {s: out for s, _, _, _, out in batched}
        print("    restart 0 batched vs its own R = 1 loss at the same "
              "theta (max|batched[0] - alone[0]| / max|batched[0]|):")
        for s in STEPS:
            if s in one and s in many:
                b = many[s][0] if isinstance(many[s], tuple) else many[s]
                o = one[s][0] if isinstance(one[s], tuple) else one[s]
                print(f"      {s:8s} {_rel(b[:1], o[:1])!r}")
        fa = {s: a for s, _, a, _, _ in batched}
        fo = {s: a for s, _, a, _, _ in alone}
        if "c" in many and "cfactor" in fa:
            for label, c, a_in in (("batch", many["c"][0], fa["cfactor"][0][0]),
                                   ("alone", one["c"][0], fo["cfactor"][0][0])):
                lam = torch.linalg.eigvalsh(a_in.double().cpu())
                ok_b = int(self._chol(a_in[None]).info.reshape(-1)[0])
                ok_a = int(self._chol(a_in).info)
                print(f"      C ({label}): smallest eigenvalue of C + rI "
                      f"{float(lam[0])!r} (largest {float(lam[-1])!r}); "
                      f"max|C - C^T| {float(torch.max(torch.abs(c - c.mT)))!r}"
                      f"; its factor's info as a batch of 1 {ok_b}, as a "
                      f"matrix {ok_a}")
            print(f"      max|C_batch - C_alone| / max|C_batch| "
                  f"{_rel(many['c'][0], one['c'][0])!r}")
        for label, p in (("batched", prof), ("alone", prof_alone)):
            print(f"    CUDA kernels of the {label} loss at evaluation {ev}:"
                  + _kernels(p))


@contextlib.contextmanager
def _profiled():
    """torch.profiler over the block on a card; None on the host."""
    if not torch.cuda.is_available():
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()


def _kernels(prof):
    if prof is None:
        return " (not profiled on the host)"
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    return "".join(f"\n      {e.count:4d} x {e.self_device_time_total:10.1f}"
                   f" us  {e.key[:150]}" for e in rows[:24])


def report(hooks, regs):
    lam = np.asarray(hooks.margins)
    ratio = lam[:, 0] / lam[:, 2]
    print(f"    restart 0's C + rI at {len(lam)} evaluations: smallest "
          f"eigenvalue / r min {float(ratio.min())!r}, below 0.5 at "
          f"{int((ratio < 0.5).sum())}, below 0 at {int((lam[:, 0] < 0).sum())}"
          f"; largest eigenvalue {float(lam[:, 1].min())!r} .. "
          f"{float(lam[:, 1].max())!r}")
    print("    (evaluation, smallest, largest, r): "
          + "; ".join(f"{i} {a:.6g} {b:.6g} {c:.6g}"
                      for i, (a, b, c) in enumerate(lam)))
    losses, failed = np.stack(hooks.losses), np.stack(hooks.failed)
    for r, reg in enumerate(regs):
        bad = ~np.isfinite(losses[:, r])
        first = int(np.argmax(bad)) if bad.any() else None
        which = ("none" if first is None else
                 "+".join(name for name, f in
                          zip(("K_mm", "C"), failed[first, :, r]) if f)
                 or "neither factor (a NaN in the loss itself)")
        print(f"    restart {r} (initial ridge {reg:g}): "
              f"{int(bad.sum())} of {len(losses)} evaluations not "
              f"finite, the first at evaluation {first} ({which}); "
              f"final loss {float(losses[-1, r])!r}")


def run_arm(arm, x_tr, y_tr, diagnose):
    device = torch.device("cpu" if arm == "cpu" else "cuda")
    kw = {"reg_restarts": ()} if arm == "cuda-r0" else {}
    regs = (1e-3,) if arm == "cuda-r0" else (1e-3, 3e-2, 0.3)
    loop = arm[5:] if arm.startswith("loop-") else None
    with contextlib.ExitStack() as stack:
        if arm == "cuda-magma":
            backend = torch.backends.cuda.preferred_linalg_library()
            torch.backends.cuda.preferred_linalg_library("magma")
            stack.callback(torch.backends.cuda.preferred_linalg_library,
                           backend)
        c_moments = C_MOMENTS.get(arm, c_fp32_batched)
        if c_moments is not None:
            # the other arms start from the batched fp32 loss of before
            # PR 10 unless C_MOMENTS names theirs
            stack.callback(setattr, hyperopt, "_c_moments",
                           hyperopt._c_moments)
            hyperopt._c_moments = c_moments
        hooks = stack.enter_context(Hooks(loop, diagnose))
        res, secs = chip_smoke.best_learn(x_tr, y_tr, device, **kw)
    print(f"  {arm}: {secs!r} s, log evidence {float(res.log_evidence)!r}, "
          f"w={res.w!r} b={res.b!r} diag_reg={res.diag_reg!r}")
    report(hooks, regs)


def time_c(reps=20):
    """C and b alone at the learn's shape, each variant's ms (CUDA events,
    after a warm-up), forward and forward + backward: every variant timed
    twice, in the order 1 2 3 4 4 3 2 1, and the two means averaged."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    psi = torch.randn((3, 512, 90000), generator=gen, device="cuda")
    ym = torch.randn((90000, 1), generator=gen, device="cuda")
    variants = (("fp32 batched", c_fp32_batched), ("fp32 loop", c_fp32_loop),
                ("fp64 batched", c_fp64_batched), ("fp64 loop", c_fp64_loop))
    for backward in (False, True):
        p = psi.detach().requires_grad_(backward)
        times = {name: [] for name, _ in variants}
        for name, fn in variants + variants[::-1]:
            def run():
                c, b = fn(p, ym)
                if backward:
                    torch.autograd.grad((c.sum() + b.sum()), p)

            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                run()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
        for name, (t1, t2) in times.items():
            print(f"  C and b {name}{' + backward' if backward else ''}: "
                  f"{(t1 + t2) / 2!r} ms ({t1!r}, {t2!r})", flush=True)
    del psi, ym
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", default="cuda,cuda-fp64-loop,cuda-fp32c")
    ap.add_argument("--time_c", action="store_true",
                    help="time C and b alone first")
    ap.add_argument("--diagnose", type=int, default=3,
                    help="the evaluation to diagnose in the first batched "
                         "arm (-1: none)")
    args = ap.parse_args(argv)
    arms = args.arms.split(",")
    if any(a not in ARMS for a in arms):
        ap.error(f"--arms: each of {ARMS}")
    if any(a != "cpu" for a in arms) and not torch.cuda.is_available():
        ap.error("the cuda arms need a GPU")
    print(chip_smoke.card_line() if torch.cuda.is_available()
          else "no GPU", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.get_num_threads()} CPU threads", flush=True)
    if args.time_c:
        time_c()
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train, _ = chip_smoke.big_split(tmp)
        x_tr, y_tr = chip_smoke.encode_big(train)
    print(f"synth6_big train split {x_tr.shape} encoded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    first = next((a for a in arms if a == "cuda-batched"), None)
    for arm in arms:
        run_arm(arm, x_tr, y_tr, args.diagnose if arm == first else None)
        sys.stdout.flush()


if __name__ == "__main__":
    main()
