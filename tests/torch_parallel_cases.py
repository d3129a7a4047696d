"""Rank programs for the `tests/test_torch_parallel*.py` files, and the
runner that executes one on p gloo CPU ranks.

`on_ranks(p, name, payload)` runs `name(mesh, payload)` on every rank of a
p-rank mesh and returns the list of the ranks' results (nested dicts,
tuples and lists of numpy arrays and numbers). p = 1 runs in this process
on a world-size-1 `HashStore` group; p > 1 spawns p processes (gloo, a
`file://` rendezvous in a fresh temporary directory, so concurrent test
workers never share one) that unpickle the payload, run the program and
pickle their results into that directory. Each test file calls it once per
p from a module-scoped fixture: spawning costs a few seconds.
`spawn_ranks` starts the ranks and returns at once, so that several worlds
and the test process's own work run together.

This module imports no jax: the spawned ranks import it.
"""

import importlib
import os
import pickle
import tempfile

import numpy as np
import torch

# spawned ranks rendezvous within this long or fail
_INIT_TIMEOUT_S = 120


def _numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_numpy(v) for v in tree)
    return tree


def _program(name):
    return getattr(importlib.import_module(__name__), name)


def _rank_main(rank, world, tmp, name, payload):
    import datetime

    import torch.distributed as dist

    from nngp_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=_INIT_TIMEOUT_S))
    try:
        out = _numpy(_program(name)(make_mesh(world, device="cpu"), payload))
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def on_ranks(world: int, name: str, payload):
    """[name(mesh, payload) on rank r for r in range(world)]."""
    if world == 1:
        from nngp_tpu_torch.parallel import make_mesh

        return [_numpy(_program(name)(make_mesh(1, device="cpu"), payload))]
    return spawn_ranks(world, name, payload)()


def spawn_ranks(world: int, name: str, payload):
    """Start name(mesh, payload) on `world` spawned ranks and return a
    function that waits for them and returns on_ranks' list, so that
    several worlds (and work in this process) can run at once."""
    import torch.multiprocessing as mp

    tmp = tempfile.TemporaryDirectory()
    ctx = mp.start_processes(_rank_main, args=(world, tmp.name, name,
                                               payload),
                             nprocs=world, join=False, start_method="spawn")

    def results():
        try:
            while not ctx.join():
                pass
            out = []
            for r in range(world):
                with open(os.path.join(tmp.name, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            tmp.cleanup()

    return results


def shard(a, mesh):
    """This rank's contiguous rows of a whole (n, ...) array."""
    p, d = int(mesh.size()), int(mesh.get_local_rank())
    m = a.shape[0] // p
    return torch.as_tensor(np.ascontiguousarray(a[d * m:(d + 1) * m]))


# ------------------------------------------------------------- programs
def linalg(mesh, pl):
    """The factor and the three solves of pl['k'] in storage order, for
    every block size in pl['blocks']; this rank's rows of each."""
    from nngp_tpu_torch.parallel import (cyclic_storage_order,
                                         distributed_cho_solve,
                                         distributed_cholesky,
                                         distributed_tri_solve_lower,
                                         distributed_tri_solve_lower_t)
    p = int(mesh.size())
    n = pl["k"].shape[0]
    out = {}
    for b in pl["blocks"]:
        g2e = cyclic_storage_order(n, b, p)
        k, rhs = shard(pl["k"][g2e], mesh), shard(pl["rhs"][g2e], mesh)
        l = distributed_cholesky(k, mesh, block_size=b)
        out[b] = {
            "l": l, "k_untouched": bool(torch.equal(
                k, shard(pl["k"][g2e], mesh))),
            "fwd": distributed_tri_solve_lower(l, rhs, mesh, block_size=b),
            "bwd": distributed_tri_solve_lower_t(l, rhs, mesh,
                                                 block_size=b),
            "cho": distributed_cho_solve(l, rhs, mesh, block_size=b)}
    return out


def sharded(mesh, pl):
    """sharded_gram rows, sharded_fit and sharded_predict_mean_std, and
    the distributed fit's storage Gram (the generic-diagonal pin)."""
    from nngp_tpu_torch.parallel import (sharded_fit, sharded_gram,
                                         sharded_predict_mean_std)
    from nngp_tpu_torch.parallel.cholesky import cyclic_storage_order
    from nngp_tpu_torch.parallel.sharded import _gram_storage, _ridge
    spec, x, y, xt = pl["spec"], pl["x"], pl["y"], pl["xt"]
    p, d = int(mesh.size()), int(mesh.get_local_rank())
    out = {"gram": {g: sharded_gram(spec, x, mesh, g)
                    for g in ("nngp", "ntk")}}
    for get in ("nngp", "ntk"):
        fit = sharded_fit(spec, x, y, mesh, get=get)
        k_tt = fit[3] if get == "ntk" else None
        out[get] = {"fit": fit, "predict": sharded_predict_mean_std(
            spec, xt, x, fit[0], fit[1], mesh, get=get, k_tt=k_tt)}
    n, b = x.shape[0], pl["b"]
    g2e = cyclic_storage_order(n, b, p)
    xt_ = torch.as_tensor(x)
    reg = _ridge(xt_, spec.layers, "ntk", 1e-3)
    mine = torch.as_tensor(g2e[d * (n // p):(d + 1) * (n // p)])
    k_tt, solve = _gram_storage(spec, xt_[mine].contiguous(), xt_, reg, p,
                                d, b, True, n)
    rows = torch.arange(n // p)
    out["pin"] = {"reg": reg, "nngp_diag": k_tt[rows, mine],
                  "ntk_diag": solve[rows, mine] - reg}
    return out


def _refit_ridge(spec, x, input_scale, reg, get):
    """The relative diag_reg at which a fit of raw rows x gets the
    absolute ridge `reg` (prescaled units)."""
    from nngp_tpu_torch.models.kernel_spec import diag_eval

    xs = torch.as_tensor(x) * (1.0 / input_scale)
    return float(reg) / float(torch.mean(diag_eval(spec.layers, xs, get)))


def posterior(mesh, pl):
    """distributed_fit of pl's ragged rows for both gets: alpha, the
    natural-order rows, every predict, the evidence, a chunked predict,
    the checkpoint gather and this rank's shards."""
    from nngp_tpu_torch.parallel import distributed_fit
    xt = pl["xt"]
    out = {}
    for get in ("nngp", "ntk"):
        post = distributed_fit(pl["spec"], pl["x"], pl["y"], mesh, get=get,
                               block_size=pl["b"],
                               input_scale=pl["input_scale"])
        out[get] = {
            "alpha": post.alpha_natural(), "x": post.x_natural(),
            "y": post.y_natural(), "padded": post.num_padded,
            "train": post.num_train, "mean_std": post.predict_mean_std(xt),
            "cov": post.predict(xt, True), "diag": post.predict(xt, "diag"),
            "mean_only": post.predict(xt, False),
            "lml": post.log_marginal_likelihood(),
            "chunked": post.predict_mean_std_chunked(xt, chunk=7),
            "state": post.gather_state(),
            "shards": {"x_storage": post.x_storage,
                       "y_storage": post.y_storage, "l": post.l,
                       "alpha": post.alpha, "k_tt": post.k_tt}}
    return out


def extend(mesh, pl):
    """Extends of a ragged fit inside and beyond its pad (and a second one
    on top), beside a refit on the merged rows with the fit's ridge."""
    from nngp_tpu_torch.parallel import distributed_fit
    spec, xt = pl["spec"], pl["xt"]
    out = {}
    for get in ("nngp", "ntk"):
        post = distributed_fit(spec, pl["x"], pl["y"], mesh, get=get,
                               block_size=pl["b"],
                               input_scale=pl["input_scale"])
        for m_new in pl["m_new"]:
            xn, yn = pl["x_new"][:m_new], pl["y_new"][:m_new]
            ext = post.extend(xn, yn)
            x_all = np.concatenate([pl["x"], xn])
            refit = distributed_fit(
                spec, x_all, np.concatenate([pl["y"], yn]), mesh, get=get,
                block_size=pl["b"], input_scale=pl["input_scale"],
                diag_reg=_refit_ridge(spec, x_all, pl["input_scale"],
                                      post.reg, get))
            out[get, m_new] = {
                "padded": ext.num_padded, "train": ext.num_train,
                "x": ext.x_natural(), "y": ext.y_natural(),
                "alpha": ext.alpha_natural(),
                "mean_std": ext.predict_mean_std(xt),
                "refit": refit.predict_mean_std(xt),
                "ext2": ext.extend(pl["x2"], pl["y2"]).predict_mean_std(xt)}
    return out


def from_jax(mesh, pl):
    """The port's posterior built from a JAX DistributedPosterior's arrays
    (`convert.distributed_from_numpy`), predicting pl['xt']."""
    from nngp_tpu_torch.convert import distributed_from_numpy
    post = distributed_from_numpy(
        pl["arrs"], pl["spec"], pl["get"], mesh, pl["block_size"],
        pl["n_real"], pl["input_scale"], g2e=pl["g2e"])
    return {"mean_std": post.predict_mean_std(pl["xt"]),
            "cov": post.predict(pl["xt"], True),
            "lml": post.log_marginal_likelihood(),
            "alpha": post.alpha_natural()}


def dtc(mesh, pl):
    """The masked DTC loss and its gradient summed over ranks (each rank
    its rows of the mask-padded set), for every (name, get, theta) of
    pl['losses'], and mesh hyperopt learns beside the same learns without
    a mesh."""
    import torch.distributed as dist

    from nngp_tpu_torch.gp import hyperopt as H
    from nngp_tpu_torch.parallel.mesh import all_reduce_sum_many
    group = mesh.get_group()
    p, d = dist.get_world_size(group), dist.get_rank(group)
    x, y, m = pl["x"], pl["y"], pl["m"]
    pad = (-x.shape[0]) % p
    mask = np.concatenate([np.ones(x.shape[0]), np.zeros(pad)])
    xp = np.concatenate([x, np.zeros((pad, x.shape[1]))])
    yp = np.concatenate([y, np.zeros((pad, 1))])
    rows = slice(d * (xp.shape[0] // p), (d + 1) * (xp.shape[0] // p))
    x_loc, y_loc = torch.as_tensor(xp[rows]), torch.as_tensor(yp[rows])
    duals = H._grad_safe_duals(1e-12)
    out = {"losses": {}, "learns": {}}
    for name, get, theta in pl["losses"]:
        th = {k: torch.tensor(np.stack([v, v + 0.05]), requires_grad=True)
              for k, v in theta.items()}
        val = H._nll_dtc(th, x_loc, y_loc, m, 1, "relu", 512, get, duals,
                         mask=torch.as_tensor(mask[rows]),
                         x_m=torch.as_tensor(x[:m]), group=group)
        grads = dict(zip(th, torch.autograd.grad(val.sum(),
                                                 list(th.values()))))
        out["losses"][name] = (val, dict(zip(grads, all_reduce_sum_many(
            list(grads.values()), group))))
    for name, kw in pl["learns"]:
        res = H.fit_kernel_hyperparams(x, y, objective="dtc", mesh=mesh,
                                       **kw)
        plain = H.fit_kernel_hyperparams(x, y, objective="dtc",
                                         device="cpu", **kw)
        out["learns"][name] = [
            {"w0": r.w0, "w": r.w, "b": r.b, "diag_reg": r.diag_reg,
             "log_evidence": r.log_evidence, "hist": r.nll_history,
             "num_points": r.num_points, "feature_scale": r.feature_scale}
            for r in (res, plain)]
    return out


def nystrom(mesh, pl):
    """fit_nystrom(mesh=) for both gets, its moments and predictions, an
    extend and a forget through the mesh; the same without a mesh."""
    from nngp_tpu_torch.gp import fit_nystrom
    out = {}
    for get, moments in pl["arms"]:
        dtype = np.float32 if moments == "df64" else np.float64
        kw = dict(num_inducing=pl["m"], get=get, panel_size=pl["panel"],
                  input_scale=1.0, moments=moments)
        x, y = pl["x"].astype(dtype), pl["y"].astype(dtype)
        xn, yn = pl["x_new"].astype(dtype), pl["y_new"].astype(dtype)
        arm = {}
        for key, mesh_kw in (("mesh", {"mesh": mesh}),
                             ("plain", {"device": "cpu"})):
            post = fit_nystrom(pl["spec"], x, y, **kw, **mesh_kw)
            ext = post.extend(xn, yn)
            back = ext.forget(xn, yn)
            arm[key] = {
                "moments": [post.c_raw, post.b_w, post.m1_w, post.diag_sum,
                            post.yty],
                "num_train": (post.num_train, ext.num_train),
                "mean_std": post.predict_mean_std(pl["xt"].astype(dtype)),
                "ext": ext.predict_mean_std(pl["xt"].astype(dtype)),
                "back_c": back.c_raw, "evidence": post.log_evidence(),
                "has_mesh": (post.mesh is not None, ext.mesh is not None)}
        out[get, moments] = arm
    return out


def nystrom_high(mesh, pl):
    """fit_nystrom(mesh=, precision='high') on fp32 rows: the moments, an
    extend and a forget through the mesh, the predictions; the moments of
    the same fit without a mesh."""
    from nngp_tpu_torch.gp import fit_nystrom
    kw = dict(num_inducing=pl["m"], panel_size=pl["panel"], input_scale=1.0,
              precision="high")
    post = fit_nystrom(pl["spec"], pl["x"], pl["y"], mesh=mesh, **kw)
    plain = fit_nystrom(pl["spec"], pl["x"], pl["y"], device="cpu", **kw)
    ext = post.extend(pl["x_new"], pl["y_new"])
    back = ext.forget(pl["x_new"], pl["y_new"])
    moments = [post.c_raw, post.b_w, post.diag_sum, post.yty, back.c_raw]
    return {"mesh": moments,
            "plain": [plain.c_raw, plain.b_w, plain.diag_sum, plain.yty,
                      plain.c_raw],
            "precision": (post.precision, ext.precision),
            "num_train": (post.num_train, ext.num_train, back.num_train),
            "mean_std": post.predict_mean_std(pl["xt"])}


def rpchol(mesh, pl):
    """fit_nystrom(inducing='rpchol', mesh=): the inducing rows this rank
    holds (rank 0 selects and broadcasts), the predictions and an extend's."""
    from nngp_tpu_torch.gp import fit_nystrom
    post = fit_nystrom(pl["spec"], pl["x"], pl["y"], num_inducing=pl["m"],
                       get=pl["get"], seed=pl["seed"], inducing="rpchol",
                       mesh=mesh)
    return {"x_m": post.x_m, "mean_std": post.predict_mean_std(pl["xt"]),
            "ext": post.extend(pl["x_new"], pl["y_new"]).predict_mean_std(
                pl["xt"])}


def active(mesh, pl):
    """ActiveLearner(mesh=) runs: (validation MSE history, final train
    count, final padded count) per configuration of pl['learners']."""
    from nngp_tpu_torch.active import ActiveLearner
    out = {}
    for name, kw in pl["learners"]:
        kw = dict(kw)
        data = pl["data"][kw.pop("data")]
        learner = ActiveLearner(pl["spec"], mesh=mesh, device="cpu", **kw)
        post, hist = learner.active_train(*data, printer=None)
        out[name] = {"hist": [h["val_mse"] for h in hist],
                     "num_train": [h["num_train"] for h in hist],
                     "final": (post.num_train, post.num_padded,
                               type(post).__name__)}
    return out


def estimator(mesh, pl):
    """Estimator(tier='distributed') on the toy two-table schema for both
    kernels: predictions, an online extend, a checkpoint written and
    restored over the mesh, and a JAX checkpoint restored
    (pl['jax_ckpt'])."""
    from nngp_tpu_torch.featurize.stats import TableStats
    from nngp_tpu_torch.serve import Estimator
    stats = [TableStats.from_json(s) for s in pl["stats"]]
    p = int(mesh.size())
    out = {}
    for get in ("nngp", "ntk"):
        est = Estimator("toy", None, pl["qdir"], stats=stats,
                        dtype=np.float64, verbose=False, kernel_type=get,
                        tier="distributed", mesh=mesh,
                        dist_block_size=pl["b"], device="cpu")
        post = est.posterior
        r = {"predict": est.predict(pl["lines"]),
             "layout": (type(post).__name__, post.num_train,
                        post.num_padded, post.block_size)}
        est.extend_with_lines(pl["new"])
        r["extended"] = est.predict(pl["lines"])
        r["extended_train"] = est.posterior.num_train
        ckpt = os.path.join(pl["out"], f"{get}-p{p}")
        est.save(ckpt)
        back = Estimator.restore(ckpt, mesh=mesh, device="cpu")
        r["restored"] = back.predict(pl["lines"])
        r["restored_layout"] = (back.dist_block_size,
                                back.posterior.num_train)
        if p in pl["jax_ckpt"]:
            jest = Estimator.restore(pl["jax_ckpt"][p][get], mesh=mesh,
                                     device="cpu")
            r["from_jax"] = jest.predict(pl["lines"])
        out[get] = r
    return out


def _socket_client(srv, lines):
    """The server's replies to `lines`, sent on one connection."""
    import json
    import socket

    with socket.create_connection((srv.host, srv.port), timeout=120) as sk:
        f = sk.makefile("rwb")
        f.write("".join(ln + "\n" for ln in lines).encode())
        f.flush()
        sk.shutdown(socket.SHUT_WR)
        return [json.loads(raw.decode()) for raw in f]


def _until(cond, seconds=120.0):
    import time

    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError("the server did not get there in time")
        time.sleep(0.02)


def _serve(lead, pl, idle_s):
    """Rank 0's session: calibrate; 4 batcher clients (client 0 adds
    pl['bad']); the socket server, feedback_mode='auto', with the queries
    and pl['bad'], then the feedback batches pl['feedback'] (one batch
    each: feedback_batch is their size and the flush never fires first),
    then the queries again; an idle period of idle_s; one predict.
    The intervals come from predict_interval: the socket's would overflow
    2 ** hi at the toy's stds."""
    import threading
    import time

    from nngp_tpu_torch.serve import EstimatorSocketServer, StreamingBatcher

    lines, bad = pl["lines"], pl["bad"]
    lead.calibrate_uncertainty(pl["cal"], verbose=False)
    interval = lead.predict_interval(lines, alpha=0.1)
    batcher = [None] * 4
    with StreamingBatcher(lead.predict, max_wait_ms=5.0) as b:
        def client(c):
            futs = [b.submit(ln) for ln in lines + [bad] * (c == 0)]
            out = []
            for f in futs:
                try:
                    out.append(f.result(timeout=120))
                except ValueError as e:
                    out.append(f"error: {e}")
            batcher[c] = out

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    fb = pl["feedback"]
    with EstimatorSocketServer(lead, port=0, feedback_mode="auto",
                               feedback_batch=len(fb[0]),
                               feedback_flush_s=600.0) as srv:
        first = _socket_client(srv, lines + [bad] + lines[:1])
        for k, batch in enumerate(fb):
            acks = _socket_client(srv, batch)
            assert all(a.get("feedback") == "queued" for a in acks)
            # counted under the model lock: a later predict waits for the
            # rest of this batch's feedback, remediation included
            _until(lambda: srv.stats()["feedback_lines"]
                   >= (k + 1) * len(batch))
        after = _socket_client(srv, lines)
        stats = srv.stats()
    time.sleep(idle_s)
    return {"interval": interval, "batcher": batcher, "first": first,
            "after": after,
            "stats": stats, "after_idle": lead.predict(lines),
            "keepalives": lead.keepalives}


def frontends(mesh, pl):
    """The front ends over a distributed Estimator, for both kernels, on
    the toy schema in fp64: rank 0 serves through a LeadEstimator (`_serve`,
    idle for pl['idle_s'][get] seconds) and the other ranks follow; then, on every rank, the predictions of
    pl['lines'], the train count and the calls replayed (on rank 0 the
    lead's count, its followers' and what it served). At world size > 1,
    also the error a plain Estimator gets from each front end (and the
    batcher's pipelined mode)."""
    from nngp_tpu_torch.featurize.stats import TableStats
    from nngp_tpu_torch.parallel.mesh import is_lead
    from nngp_tpu_torch.serve import (DriftMonitor, Estimator,
                                      EstimatorSocketServer, LeadEstimator,
                                      StreamingBatcher, follow)
    stats = [TableStats.from_json(s) for s in pl["stats"]]
    out = {}
    for get in ("nngp", "ntk"):
        est = Estimator("toy", None, pl["qdir"], stats=stats,
                        dtype=np.float64, verbose=False, kernel_type=get,
                        tier="distributed", mesh=mesh,
                        dist_block_size=pl["b"], device="cpu")
        est.drift_monitor = DriftMonitor(warmup=pl["warmup"])
        r = {}
        if is_lead(mesh):
            with LeadEstimator(est, timeout=pl["timeout_s"]) as lead:
                r["served"] = _serve(lead, pl, pl["idle_s"].get(get, 0.0))
            r["calls"], r["replayed"] = lead.calls, lead.replayed
            # the control group's object, released when the lead closed
            r["released"] = lead._chan is None or lead._chan.group is None
        else:
            r["replayed"] = follow(est, timeout=pl["timeout_s"])
        r["final"] = est.predict(pl["lines"])
        r["num_train"] = est.posterior.num_train
        out[get] = r
    if int(mesh.size()) > 1:
        refused = []
        for build in (lambda: StreamingBatcher(est.predict),
                      lambda: StreamingBatcher(dispatch_fn=est.predict,
                                               fetch_fn=lambda h: h),
                      lambda: EstimatorSocketServer(est)):
            try:
                build().close()
            except ValueError as e:
                refused.append(str(e))
        out["refused"] = refused
    return out


def estimator_learn(mesh, pl):
    """The Estimator's learning paths over a mesh beside the same without
    one: the Nystrom tier's mesh moments (fit, extend of lines, a
    checkpoint restored over the mesh), the DTC learn with mesh=, and a
    relearn on the distributed tier (its rows gathered)."""
    from nngp_tpu_torch.featurize.stats import TableStats
    from nngp_tpu_torch.serve import Estimator
    stats = [TableStats.from_json(s) for s in pl["stats"]]
    p = int(mesh.size())

    def build(**kw):
        return Estimator("toy", None, pl["qdir"], stats=stats,
                         dtype=np.float64, verbose=False, device="cpu", **kw)

    out = {}
    for key, kw in (("nystrom", dict(nystrom_m=24)),
                    ("dtc_learn", dict(nystrom_m=24, learn_hyper=True,
                                       hyper_steps=3, hyper_points=0))):
        pair = {}
        for side, extra in (("mesh", {"mesh": mesh}), ("plain", {})):
            est = build(**kw, **extra)
            r = {"predict": est.predict(pl["lines"]),
                 "spec": [(l.w_std, l.b_std) for l in est.spec.layers
                          if type(l).__name__ == "Dense"],
                 "diag_reg": est.diag_reg}
            est.extend_with_lines(pl["new"])
            r["extended"] = est.predict(pl["lines"])
            if side == "mesh":
                ckpt = os.path.join(pl["out"], f"{key}-p{p}")
                est.save(ckpt)
                back = Estimator.restore(ckpt, mesh=mesh, device="cpu")
                r["restored_mesh"] = back.posterior.mesh is mesh
                back.extend_with_lines(pl["new"])
                est.extend_with_lines(pl["new"])
                r["restored_extend"] = (back.predict(pl["lines"]),
                                        est.predict(pl["lines"]))
            pair[side] = r
        out[key] = pair
    relearned = {}
    for side, extra in (("mesh", {"mesh": mesh, "tier": "distributed"}),
                        ("plain", {})):
        est = build(**extra)
        ev = est.relearn_hyperparams(steps=3, max_points=None,
                                     verbose=False)
        relearned[side] = {"evidence": ev, "diag_reg": est.diag_reg,
                           "predict": est.predict(pl["lines"])}
    out["relearn"] = relearned
    return out


def save_estimator(mesh, pl):
    """An fp64 Estimator(tier='distributed') on the toy schema, saved to
    pl['ckpt'] (the serving demo restores it over a mesh of this size)."""
    from nngp_tpu_torch.featurize.stats import TableStats
    from nngp_tpu_torch.serve import Estimator
    est = Estimator("toy", None, pl["qdir"],
                    stats=[TableStats.from_json(s) for s in pl["stats"]],
                    dtype=np.float64, verbose=False, tier="distributed",
                    mesh=mesh, dist_block_size=pl["b"], device="cpu")
    est.save(pl["ckpt"])
    return est.posterior.num_train
