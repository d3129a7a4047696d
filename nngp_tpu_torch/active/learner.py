"""Posterior-variance active learning on the exact or the Nystrom tier
(PyTorch counterpart of `nngp_tpu/active/learner.py`).

Each round predicts the unlabeled pool, normalizes the std by max(mean)
(coefficient of variation), selects `budget` points (biased sampling with p
proportional to the normalized std, top-k std, or batch-diverse greedy
conditional variance), merges them into the train set and updates the
posterior: an O(n^2 k) `GPPosterior.extend` by default (on the Nystrom
tier an exact moment extend, or with nystrom_grow an inducing-set growth),
a full refit with refit='full', or a hyperparameter relearn and refit with
relearn_hyper.

The pools, the train set and the selection stay on the learner's device.
What differs from the JAX learner:
  - biased sampling draws Gumbel-top-k (the law of `jax.random.choice(p=,
    replace=False)`) from a `torch.Generator` on the pool's device seeded
    from `seed`; it cannot reproduce JAX's bits;
  - greedy selection runs on the exact pool slice: the JAX learner pads it
    to a power of two to reuse compiled programs, and masked pad rows
    cannot change the selection;
  - a relearn round refits with the learned spec itself, whose layer
    program reaches the CUDA Gram kernels by value at every launch (the
    JAX learner passes traced `spec_params` so jit compiles once).

pad_acquisitions pads the exact posterior as the JAX learner does
(`fit_gp(pad_to=n0 + budget * active_iters)`): incremental rounds write
their rows into its slots in place, refit and relearn rounds pad again.

With mesh= (a `parallel.make_mesh` DeviceMesh) the loop runs on the
row-sharded distributed posterior (`parallel.distributed_fit`, rounds by
`DistributedPosterior.extend`), or with nystrom_m on moments streamed over
the mesh. It is collective: every rank runs the same learner on the same
data, and the selections agree because every prediction is replicated.
"""

import numpy as np
import torch

from nngp_tpu_torch.eval.qerror import PredictionStatistics
from nngp_tpu_torch.gp import GPPosterior, fit_gp, fit_nystrom
from nngp_tpu_torch.models.kernel_spec import Activation, Dense, KernelSpec
from nngp_tpu_torch.parallel.mesh import check_mesh_device
from nngp_tpu_torch.parallel.sharded import distributed_fit
from nngp_tpu_torch.utils.device import resolve_device


class ActiveLearner:
    # pools larger than this predict in chunks of 8,192 rows, so the cross
    # Gram of a selection step stays chunk x n
    CHUNKED_POOL_MIN = 32768
    # greedy selection pre-filters pools beyond this to the top-M marginal
    # variance slice (M also floored at twice the budget): the (P, P)
    # covariance and the O(k P^2) loop are the cost
    GREEDY_POOL_MAX = 4096

    def __init__(self, spec: KernelSpec, budget: int = 1000,
                 active_iters: int = 3, kernel_type: str = "nngp",
                 biased_sample: bool = True, diag_reg: float = 1e-3,
                 refit: str = None, seed: int = 10,
                 mesh=None, dist_block_size=None, input_scale=None,
                 nystrom_m=None, nystrom_grow: int = 0,
                 nystrom_moments: str = "fp32", relearn_hyper=None,
                 hyper_warm_steps: int = 40, hyper_points=2048,
                 hyper_ard: bool = False, selection: str = None,
                 partition_keys: str = "num_predicates",
                 pad_acquisitions: bool = False, *, device):
        """The arguments of the JAX learner, plus `device` (required;
        'cuda' without a GPU raises). Inputs may be numpy arrays or
        tensors; they are moved to `device`.

        relearn_hyper: relearn the kernel hyperparameters after every
        acquisition round, warm-started from the previous optimum
        (`gp.hyperopt`, `hyper_warm_steps` Adam steps, no restarts), then
        refit with the new spec. Pass the initial HyperoptResult, or True
        to cold-learn on the first train split inside `active_train`.
        Inputs stay raw: the learner applies the current learned ARD scale
        itself. `refit` is ignored on relearn rounds.

        selection: 'biased' / 'topk' (default: 'biased' when biased_sample
        else 'topk') or 'greedy'.

        nystrom_m: run the loop on the streaming Nystrom/DTC tier with
        this many inducing rows (`gp.nystrom`); rounds extend its moments
        exactly, and relearns maximize the DTC evidence. nystrom_moments:
        'fp32' or 'df64'. nystrom_grow: with nystrom_m, also grow the
        inducing set each round by this many seeded uniform rows of the
        acquired batch (`NystromPosterior.grow_inducing`, a streamed
        refit).

        mesh: fit and update the row-sharded distributed posterior over
        this DeviceMesh (`dist_block_size` its panel width), or with
        nystrom_m stream the Nystrom moments over it; the learner's device
        must be the mesh's type. refit defaults to 'incremental' on every
        tier.

        pad_acquisitions (single-device exact nngp tier only): the initial
        fit pads its storage to n0 + budget * active_iters rows
        (`fit_gp(pad_to=)`), incremental rounds extend it in place, and
        refit and relearn rounds pad again to the same size."""
        if pad_acquisitions and (nystrom_m is not None or mesh is not None
                                 or kernel_type != "nngp"):
            raise ValueError(
                "pad_acquisitions is the single-chip exact-nngp shape-"
                "stability feature (fit_gp pad_to); the Nystrom tier is "
                "already shape-stable (O(m^2) state) and the distributed "
                "tier pads internally")
        self.pad_acquisitions = bool(pad_acquisitions)
        self._pad_to = None          # set per active_train run
        if refit is None:
            refit = "incremental"
        if refit not in ("incremental", "full"):
            raise ValueError("refit must be 'incremental' or 'full'")
        if selection is None:
            selection = "biased" if biased_sample else "topk"
        if selection not in ("biased", "topk", "greedy"):
            raise ValueError("selection must be 'biased', 'topk' or "
                             "'greedy'")
        if nystrom_grow and nystrom_m is None:
            raise ValueError("nystrom_grow requires nystrom_m")
        if nystrom_grow and refit == "full":
            raise ValueError(
                "nystrom_grow needs refit='incremental': a full refit "
                "rebuilds the inducing set at the original nystrom_m each "
                "round, discarding the growth")
        if nystrom_grow and relearn_hyper:
            raise ValueError(
                "nystrom_grow is incompatible with relearn_hyper: relearn "
                "rounds refit with the new kernel at the original "
                "nystrom_m, discarding the growth")
        if nystrom_moments not in ("fp32", "df64"):
            raise ValueError("nystrom_moments must be 'fp32' or 'df64', got "
                             f"{nystrom_moments!r}")
        self.nystrom_m = nystrom_m
        self.nystrom_moments = nystrom_moments
        self.nystrom_grow = int(nystrom_grow)
        self._grow_rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        check_mesh_device(mesh, self.device)
        if dist_block_size is not None and mesh is None:
            raise ValueError("dist_block_size is the distributed tier's "
                             "panel width; it needs mesh=")
        self.mesh = mesh
        self.dist_block_size = dist_block_size
        self.selection = selection
        self.spec = spec
        self.budget = budget
        self.active_iters = active_iters
        self.kernel_type = kernel_type
        self.diag_reg = diag_reg
        self.refit = refit
        self.input_scale = input_scale
        self.seed = seed
        self._gen = None                  # created on the pool's device
        self.relearn = relearn_hyper is not None and relearn_hyper is not False
        # the HyperoptResult in effect (None until the cold learn when
        # relearn_hyper=True was passed instead of a result)
        self._hyper = None
        if self.relearn and relearn_hyper is not True:
            self._adopt_hyper(relearn_hyper)
        self.hyper_warm_steps = hyper_warm_steps
        self.hyper_points = hyper_points
        self.hyper_ard = hyper_ard
        self.partition_keys = partition_keys
        self.pred_stat = PredictionStatistics()

    def _dev(self, a):
        """numpy or tensor -> tensor on the learner's device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    # -- per-round hyperparameter relearning ------------------------------
    def _adopt_hyper(self, res):
        """Point the learner at a HyperoptResult's spec, ridge and
        prescale."""
        self._hyper = res
        kw = res.fit_kwargs()
        self.diag_reg = kw["diag_reg"]
        if "input_scale" in kw:          # b != 0: prescale shortcut off
            self.input_scale = kw["input_scale"]
        self.spec = res.spec

    def _hscale(self, x):
        """The current learned ARD feature scale applied (identity unless
        a relearn produced one; only in relearn mode, where the learner is
        handed raw features)."""
        if self._hyper is None or self._hyper.feature_scale is None:
            return x
        return self._hyper.scale_inputs(x)

    def _relearn_step(self, x_train, y_train):
        """Cold multi-start learn the first time, warm single-start after."""
        from nngp_tpu_torch.gp.hyperopt import fit_kernel_hyperparams

        acts = [l for l in self.spec.layers if isinstance(l, Activation)]
        kw = dict(get=self.kernel_type, max_points=self.hyper_points,
                  depth=max(len(acts), 1),
                  activation=acts[0].name if acts else "relu",
                  width=next(l.width for l in self.spec.layers
                             if isinstance(l, Dense)),
                  objective="dtc" if self.nystrom_m is not None else "exact",
                  dtc_m=min(512, self.nystrom_m or 512), device=self.device,
                  mesh=self.mesh if self.nystrom_m is not None else None)
        prev = self._hyper
        if prev is None:                 # cold start: full restarts
            res = fit_kernel_hyperparams(x_train, y_train,
                                         ard=self.hyper_ard, **kw)
        else:
            res = fit_kernel_hyperparams(
                x_train, y_train, steps=self.hyper_warm_steps,
                init=(prev.w0, prev.w, prev.b, prev.diag_reg),
                reg_restarts=(), ard=prev.feature_scale is not None,
                init_feature_scale=prev.feature_scale, **kw)
        self._adopt_hyper(res)
        return res

    def train(self, x_train, y_train):
        if self.nystrom_m is not None:
            return fit_nystrom(self.spec, self._hscale(self._dev(x_train)),
                               self._dev(y_train),
                               num_inducing=self.nystrom_m,
                               diag_reg=self.diag_reg, get=self.kernel_type,
                               input_scale=self.input_scale,
                               moments=self.nystrom_moments, mesh=self.mesh)
        if self.mesh is not None:
            # any n: the distributed layout pads with inert rows
            return distributed_fit(self.spec,
                                   self._hscale(self._dev(x_train)),
                                   self._dev(y_train), self.mesh,
                                   diag_reg=self.diag_reg,
                                   get=self.kernel_type,
                                   block_size=self.dist_block_size,
                                   input_scale=self.input_scale)
        pad_to = None
        if self.pad_acquisitions and self._pad_to is not None:
            pad_to = max(self._pad_to, x_train.shape[0])
        return fit_gp(self.spec, self._hscale(self._dev(x_train)),
                      self._dev(y_train), diag_reg=self.diag_reg,
                      get=self.kernel_type, input_scale=self.input_scale,
                      pad_to=pad_to)

    def test(self, post: GPPosterior, x_val, y_val, query_infos_val=None,
             printer=print):
        mean, _ = post.predict_mean_std(self._hscale(self._dev(x_val)))
        y_val = (y_val.cpu().numpy() if isinstance(y_val, torch.Tensor)
                 else np.asarray(y_val))
        errors = mean.cpu().numpy().ravel() - y_val.ravel()
        mse = float(np.mean(errors ** 2))
        if printer:
            printer(f"Test MSE Loss:{mse}")
        self.pred_stat.get_prediction_details(
            errors, query_infos_val, partition_keys=self.partition_keys,
            printer=printer)
        return mse

    def _pool_mean_std(self, post, x_pool):
        """(mean (P,), std (P,)) of the pool on its device, chunked above
        CHUNKED_POOL_MIN rows."""
        if x_pool.shape[0] > self.CHUNKED_POOL_MIN:
            mean, std = post.predict_mean_std_chunked(x_pool)
            return (torch.as_tensor(mean, device=x_pool.device),
                    torch.as_tensor(std, device=x_pool.device))
        mean, std = post.predict_mean_std(x_pool)
        return mean.reshape(-1), std

    def _select_greedy(self, post, x_pool, num_select):
        """Batch-diverse greedy conditional-variance acquisition
        (`active/greedy.py`). x_pool is already hyper-scaled."""
        from nngp_tpu_torch.active.greedy import greedy_variance_select

        pre = None
        # 2x headroom over the budget: pre-filtering to exactly the budget
        # would make greedy take the whole slice (top-k in disguise)
        cap = max(self.GREEDY_POOL_MAX, 2 * num_select)
        if x_pool.shape[0] > cap:
            _, std = self._pool_mean_std(post, x_pool)
            pre = torch.argsort(std, stable=True)[-cap:]
            x_pool = x_pool[pre]
        num_pool = x_pool.shape[0]
        if num_select >= num_pool:
            # everything gets selected; conditioning could only reorder
            idx = torch.arange(num_pool, device=x_pool.device)
            return pre if pre is not None else idx
        # select on the covariance in the posterior's scaled units: greedy
        # pivots are invariant to a uniform positive scaling, and raw-unit
        # variance overflows fp32 at the 2^64 packed-categorical prescale.
        # The fantasy noise is the fit's ridge, in the same scaled units.
        _, cov = post._predict_scaled(x_pool, True)
        idx = greedy_variance_select(cov, num_select, post.reg)
        return pre[idx] if pre is not None else idx

    def _generator(self, device):
        if self._gen is None or self._gen.device != device:
            self._gen = torch.Generator(device=device)
            self._gen.manual_seed(self.seed)
        return self._gen

    def select(self, post: GPPosterior, x_pool) -> torch.Tensor:
        """Acquisition indices into the pool, on the pool's device."""
        x_pool = self._hscale(self._dev(x_pool))
        num_pool = x_pool.shape[0]
        num_select = min(self.budget, num_pool)
        if num_select <= 0:
            # explicit empty selection: argsort(std)[-0:] is the whole pool
            return torch.zeros(0, dtype=torch.int64, device=x_pool.device)
        if self.selection == "greedy":
            return self._select_greedy(post, x_pool, num_select)
        mean, std = self._pool_mean_std(post, x_pool)
        # coefficient-of-variation normalization
        std = std / torch.max(mean)
        if self.selection == "biased":
            # an all-zero or underflowed std pool gives 0/0 = NaN
            # probabilities: fall back to uniform
            std = torch.nan_to_num(std)
            total = torch.sum(std)
            prob = torch.where(total > 0, std / total, 1.0 / num_pool)
            # Gumbel-top-k: num_select draws without replacement, p-weighted
            u = torch.rand(num_pool, generator=self._generator(x_pool.device),
                           dtype=prob.dtype, device=x_pool.device)
            u = torch.clamp_min(u, torch.finfo(u.dtype).tiny)
            score = torch.log(prob) - torch.log(-torch.log(u))
            return torch.argsort(score, descending=True,
                                 stable=True)[:num_select]
        return torch.argsort(std, stable=True)[-num_select:]

    @staticmethod
    def merge_data(select_indices, x_train, y_train, x_pool, y_pool):
        """Move the selected pool rows to the train set, in selection
        order; the pool keeps its other rows in their order."""
        sel = torch.as_tensor(select_indices, device=x_pool.device)
        x_delta, y_delta = x_pool[sel], y_pool[sel]
        keep = torch.ones(x_pool.shape[0], dtype=torch.bool,
                          device=x_pool.device)
        keep[sel] = False
        return (torch.cat([x_train, x_delta]), torch.cat([y_train, y_delta]),
                x_pool[keep], y_pool[keep], x_delta, y_delta)

    def active_train(self, x_train, y_train, x_pool, y_pool, x_val, y_val,
                     query_infos_val=None, printer=print):
        x_train, y_train = self._dev(x_train), self._dev(y_train)
        x_pool, y_pool = self._dev(x_pool), self._dev(y_pool)
        x_val, y_val = self._dev(x_val), self._dev(y_val)
        if self.pad_acquisitions:
            # one storage size for the whole run
            self._pad_to = int(x_train.shape[0]
                               + self.budget * self.active_iters)
        if printer:
            printer(f"# Initial Training samples: {x_train.shape[0]}")
        if self.relearn and self._hyper is None:
            # relearn_hyper=True without an initial result: cold-learn on
            # the initial train split (later rounds warm-start)
            res = self._relearn_step(x_train, y_train)
            if printer:
                printer(f"learned hyperparameters: w0={res.w0:.4f} "
                        f"w={res.w:.4f} b={res.b:.4f} "
                        f"diag_reg={res.diag_reg:.3e}")
        post = self.train(x_train, y_train)
        self.test(post, x_val, y_val, query_infos_val, printer)
        history = []
        for i in range(self.active_iters):
            if x_pool.shape[0] == 0:
                break
            select = self.select(post, x_pool)
            if select.shape[0] == 0:
                break
            if printer:
                printer(f"Active Iteration {i}: Selection {select.shape[0]}")
            (x_train, y_train, x_pool, y_pool,
             x_delta, y_delta) = self.merge_data(select, x_train, y_train,
                                                 x_pool, y_pool)
            if printer:
                printer(f"# Training samples: {x_train.shape[0]}")
            if self.relearn:
                # std-driven acquisitions move the evidence optimum: warm
                # relearn, then a full refit (a changed kernel cannot
                # extend the old factor)
                res = self._relearn_step(x_train, y_train)
                if printer:
                    printer(f"relearned: w0={res.w0:.4f} w={res.w:.4f} "
                            f"b={res.b:.4f} diag_reg={res.diag_reg:.3e} "
                            f"logev={res.log_evidence:.1f}")
                post = self.train(x_train, y_train)
            elif self.refit == "incremental" and self.nystrom_grow > 0:
                s = min(self.nystrom_grow, x_delta.shape[0])
                pick = self._grow_rng.choice(x_delta.shape[0], size=s,
                                             replace=False)
                post = post.grow_inducing(
                    self._hscale(x_delta)[torch.as_tensor(
                        pick, device=x_delta.device)],
                    self._hscale(x_train), y_train)
            elif self.refit == "incremental":
                post = post.extend(self._hscale(x_delta), y_delta)
            else:
                post = self.train(x_train, y_train)
            mse = self.test(post, x_val, y_val, query_infos_val, printer)
            history.append({"iter": i, "num_train": int(x_train.shape[0]),
                            "val_mse": mse})
        return post, history
