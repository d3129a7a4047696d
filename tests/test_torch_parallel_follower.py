"""Serving the distributed tier at world size > 1: rank 0 serves through
`nngp_tpu_torch.serve.follower.LeadEstimator` and the other ranks replay
its calls in `follow` (`tests/torch_parallel_cases.py::frontends`), at
p = 2 and 4 gloo ranks beside the same program at p = 1, on the toy
two-table schema in fp64 for both kernels. The session: a calibration, a
`StreamingBatcher` with 4 clients and one malformed line, an
`EstimatorSocketServer(feedback_mode='auto')` whose drifted feedback
batch makes the distributed tier relearn, an idle period longer than the
control group's timeout, one more predict.

The JAX package's Estimator over a p-device JAX mesh gets the same calls
in the same order (`_jax_replay`, the socket server's feedback steps).
Tolerances (max |d| / max |reference|): 1e-9 nngp and 1e-6 ntk, as in
test_torch_parallel_serve.py (sums over ranks in another order, and each
package rounds the generic NTK dual at rho = 1 its own way); the ranks'
final predictions agree bit for bit.
"""

import concurrent.futures

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import nngp_tpu.parallel as JPAR
from nngp_tpu.serve.drift import DriftMonitor as JaxDriftMonitor
from nngp_tpu.serve.estimator import Estimator as JaxEstimator
from nngp_tpu_torch.serve.follower import collective
from tests.test_active_serve import _toy_schema_files
from tests.torch_parallel_cases import on_ranks, spawn_ranks

WORLDS = (2, 4)
TOL = {"nngp": 1e-9, "ntk": 1e-6}
LINES = ["ta,tb@x,5.0,-5.0@@ta,tb,id", "ta,tb@@y,0.9,0.1@ta,tb,id",
         "ta,tb@x,1.0,-2.0@@ta,tb,id", "ta,tb@x,9.5,0.5@@ta,tb,id",
         "ta,tb@x,5.0,-5.0@@ta,tb,id"]
BAD = "ta,tb@zz,5.0,1.0@@ta,tb,id"
BLOCK = 4
# the control group's timeout (well above the ranks' skew in a relearn on
# a loaded CPU), and an idle period past it, in the nngp session
TIMEOUT_S, IDLE_S = 10.0, 11.0
# two feedback batches: calm lines (past the drift monitor's warm-up,
# shortened from 128 lines to keep the test small) and drifted ones (cards
# x4: the alarm and a relearn)
BATCH, WARMUP = 24, 16


def _labeled(seed, n, scale=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xu = rng.uniform(-10, 10)
        xl = rng.uniform(-10, xu)
        card = max(1, int(scale * 1000 * (xu - xl)))
        out.append(f"ta,tb@x,{xu:.3f},{xl:.3f}@@ta,tb,id@{card}")
    return out


CAL = _labeled(8, 30)
FEEDBACK = [_labeled(9, BATCH), _labeled(10, BATCH, scale=4.0)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cols(replies, keys=("mean", "std", "lo", "hi")):
    return [[r[k] for r in replies] for k in keys]


_JAX_FIT = JPAR.distributed_fit


def _jitted_fit(spec, x, y, mesh, **kw):
    """The JAX package's distributed_fit under jax.jit (an eager shard_map
    of the recursion takes ~15 s here)."""
    return jax.jit(lambda a, b: _JAX_FIT(spec, a, b, mesh, **kw))(
        jnp.asarray(x), jnp.asarray(y))


def _jax_replay(stats, qdir, p, get):
    """The JAX Estimator over a p-device mesh given the session's calls:
    calibrate, predict, then per feedback batch what the socket server's
    `_apply_feedback` calls (the conformal refresh after a remediation
    would come with a later batch), then predict. Run with `_jitted_fit`
    patched in."""
    jest = JaxEstimator("toy", None, qdir, stats=stats, dtype=np.float64,
                        verbose=False, kernel_type=get, tier="distributed",
                        mesh=JPAR.make_mesh(p), dist_block_size=BLOCK)
    jest.drift_monitor = JaxDriftMonitor(warmup=WARMUP)
    jest.calibrate_uncertainty(CAL, verbose=False)
    out = {"first": jest.predict(LINES),
           "interval": jest.predict_interval(LINES, alpha=0.1), "alarms": 0}
    for batch in FEEDBACK:
        report = jest.record_feedback(batch)
        jest.extend_with_lines(batch)
        if report.drift:
            out["alarms"] += 1
            jest.relearn_hyperparams(verbose=False)
            jest.drift_monitor.reset()
    out["after"] = jest.predict(LINES)
    out["num_train"] = jest.posterior.num_train
    return out


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _toy_schema_files(tmp_path_factory.mktemp("toy"))


@pytest.fixture(scope="module")
def runs(toy):
    """The program at p = 1 (no idle period: no control group), 2 and 4,
    and the JAX replays, the spawned ranks running beside the rest."""
    stats, qdir = toy
    pl = {"stats": [s.to_json() for s in stats], "qdir": qdir,
          "lines": LINES, "bad": BAD, "cal": CAL, "feedback": FEEDBACK,
          "b": BLOCK, "warmup": WARMUP, "timeout_s": TIMEOUT_S,
          "idle_s": {"nngp": IDLE_S}}
    pending = {p: spawn_ranks(p, "frontends", pl) for p in WORLDS}
    out = {}
    try:
        out[1] = on_ranks(1, "frontends", dict(pl, idle_s={}))
        keys = [(p, get) for p in WORLDS for get in ("nngp", "ntk")]
        with pytest.MonkeyPatch.context() as mp, \
                concurrent.futures.ThreadPoolExecutor(len(keys)) as pool:
            mp.setattr(JPAR, "distributed_fit", _jitted_fit)
            futs = {k: pool.submit(_jax_replay, stats, qdir, *k)
                    for k in keys}
            out["jax"] = {k: f.result() for k, f in futs.items()}
    finally:
        for p, results in pending.items():
            out[p] = results()
    return out


def _served(runs, p, get):
    return runs[p][0][get]["served"]


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_replies_match_world_size_one(runs, p, get):
    """Every reply rank 0 served, from the batcher, the socket before and
    after the feedback and after the idle period, is the world-size-1
    program's."""
    got, want = _served(runs, p, get), _served(runs, 1, get)
    for c in range(4):
        g = [v for v in got["batcher"][c] if not isinstance(v, str)]
        w = [v for v in want["batcher"][c] if not isinstance(v, str)]
        assert len(g) == len(w) == len(LINES)
        assert _rel(g, w) < TOL[get]
    for key in ("first", "after"):
        ok = [r for r in got[key] if "error" not in r]
        ok_w = [r for r in want[key] if "error" not in r]
        assert len(ok) == len(ok_w) == len(got[key]) - (key == "first")
        for a, b in zip(_cols(ok, ("mean", "std")),
                        _cols(ok_w, ("mean", "std"))):
            assert _rel(a, b) < TOL[get]
    for key in ("interval", "after_idle"):
        for a, b in zip(got[key], want[key]):
            assert _rel(a, b) < TOL[get]


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_replies_match_the_jax_mesh_estimator(runs, p, get):
    """Before the feedback, after it (three extends and a relearn) and
    after the idle period, rank 0's replies are the JAX mesh Estimator's
    predictions after the same calls."""
    got, want = _served(runs, p, get), runs["jax"][p, get]
    for a, b in zip(got["interval"], want["interval"]):
        assert _rel(a, b) < TOL[get]
    first = got["first"][:len(LINES)]
    for a, b in zip(_cols(first, ("mean", "std")), want["first"]):
        assert _rel(a, b) < TOL[get]
    for c in range(4):
        served = np.asarray(got["batcher"][c][:len(LINES)]).T
        for a, b in zip(served, want["first"]):
            assert _rel(a, b) < TOL[get]
    for a, b in zip(_cols(got["after"], ("mean", "std")), want["after"]):
        assert _rel(a, b) < TOL[get]
    for a, b in zip(got["after_idle"], want["after"]):
        assert _rel(a, b) < TOL[get]


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_the_drift_alarm_relearns_on_the_distributed_tier(runs, p, get):
    """The drifted batch raises the alarm and the remediation is a relearn
    (the exact tier's action), as in the JAX replay; no feedback line is
    lost; every rank holds the feedback rows."""
    st = _served(runs, p, get)["stats"]
    assert st["drift_alarms"] == st["remediations"] == 1
    assert runs["jax"][p, get]["alarms"] == 1
    assert st["remediations_skipped"] == st["feedback_errors"] == 0
    assert st["feedback_lines"] == len(FEEDBACK) * BATCH
    assert st["extends"] == len(FEEDBACK)
    n = 60 + len(FEEDBACK) * BATCH
    assert runs["jax"][p, get]["num_train"] == n
    assert [r[get]["num_train"] for r in runs[p]] == [n] * p


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_every_rank_ends_with_the_same_model(runs, p, get):
    """After the lead stops, every rank predicts the same values, bit for
    bit, and the world-size-1 program's within the tolerance."""
    finals = [r[get]["final"] for r in runs[p]]
    for f in finals[1:]:
        np.testing.assert_array_equal(f[0], finals[0][0])
        np.testing.assert_array_equal(f[1], finals[0][1])
    for a, b in zip(finals[0], runs[1][0][get]["final"]):
        assert _rel(a, b) < TOL[get]


@pytest.mark.parametrize("p", WORLDS)
def test_followers_replay_every_call(runs, p):
    """Each follower replayed as many calls as the lead sent, and the lead
    read the same counts; at world size 1 nothing is sent."""
    for get in ("nngp", "ntk"):
        lead = runs[p][0][get]
        assert lead["calls"] > 10
        assert lead["replayed"] == [lead["calls"]] * (p - 1)
        assert [r[get]["replayed"] for r in runs[p][1:]] == \
            [lead["calls"]] * (p - 1)
        assert (runs[1][0][get]["calls"], runs[1][0][get]["replayed"]) == \
            (0, [])


@pytest.mark.parametrize("p", WORLDS)
def test_the_lead_releases_its_control_group(runs, p):
    """Closing the lead destroys the control group and drops the object:
    the lead caches its replayed methods, bound to itself, so a kept
    reference lived to a garbage collection or to the interpreter's exit,
    where the gloo group's threads could abort the rank."""
    for get in ("nngp", "ntk"):
        assert runs[p][0][get]["released"]


@pytest.mark.parametrize("p", WORLDS)
def test_a_malformed_line_costs_only_itself(runs, p):
    """The batcher bisects the failed batch: the malformed line alone gets
    the encoder's error; on the socket its reply is an error and the next
    reply is right."""
    for get in ("nngp", "ntk"):
        served = _served(runs, p, get)
        errors = [v for c in range(4) for v in served["batcher"][c]
                  if isinstance(v, str)]
        assert errors == [served["batcher"][0][-1]]
        assert "parse error" in errors[0]
        first = served["first"]
        assert "ValueError" in first[len(LINES)]["error"]
        assert first[len(LINES) + 1] == first[0]


@pytest.mark.parametrize("p", WORLDS)
def test_an_idle_period_past_the_timeout_is_survived(runs, p):
    """In the nngp session the lead sent no-ops while idle for longer than
    the control group's timeout (a no-op a quarter of it); the predict
    after it is the one before it (and every rank reached the end: the
    fixture would have failed)."""
    served = _served(runs, p, "nngp")
    assert served["keepalives"] >= 3
    for a, b in zip(served["after_idle"], _cols(served["after"],
                                                ("mean", "std"))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("p", WORLDS)
def test_a_plain_estimator_is_refused_at_world_size_above_one(runs, p):
    """A plain Estimator given to either front end on any rank, or to the
    batcher's pipelined mode, raises a ValueError naming serve.follower:
    one rank's collective alone would wait forever."""
    for r in runs[p]:
        assert len(r["refused"]) == 3
        for msg in r["refused"]:
            assert f"world size {p}" in msg and "serve.follower" in msg


class _Stub:
    """An Estimator's surface without a mesh (world size 1)."""

    mesh = None
    std_scale = 1.5
    drift_monitor = None

    def __init__(self):
        self.seen = []

    @collective
    def predict(self, lines):
        self.seen.append(list(lines))
        if any("bad" in ln for ln in lines):
            raise ValueError("malformed line")
        return np.arange(len(lines), dtype=float), np.ones(len(lines))


def test_the_lead_passes_calls_through_at_world_size_one():
    """Without followers the lead is a pass-through: the estimator's
    attributes, results and exceptions unchanged, nothing counted; its
    `@collective` methods are bound to the lead, the batcher's predict."""
    from nngp_tpu_torch.serve import LeadEstimator, StreamingBatcher

    stub = _Stub()
    with LeadEstimator(stub) as lead:
        assert lead.std_scale == 1.5 and lead.drift_monitor is None
        assert lead.predict.__self__ is lead
        np.testing.assert_array_equal(lead.predict(["a", "b"])[0], [0, 1])
        with pytest.raises(ValueError, match="malformed"):
            lead.predict(["bad"])
        with StreamingBatcher(lead.predict) as b:
            assert b.predict(["x", "y"])[1].tolist() == [1.0, 1.0]
    assert (lead.calls, lead.replayed, lead.keepalives) == (0, [], 0)
    assert stub.seen[:2] == [["a", "b"], ["bad"]]


def test_lead_and_follow_refuse_the_wrong_rank():
    """LeadEstimator runs on coordinate 0 only, follow on the others."""
    from nngp_tpu_torch.serve import LeadEstimator, follow

    class Mesh:
        def __init__(self, rank):
            self.rank = rank

        def get_local_rank(self):
            return self.rank

    stub = _Stub()
    stub.mesh = Mesh(1)
    with pytest.raises(ValueError, match="follow"):
        LeadEstimator(stub)
    stub.mesh = Mesh(0)
    with pytest.raises(ValueError, match="LeadEstimator"):
        follow(stub)


def test_the_lead_replays_exactly_the_marked_methods():
    """The Estimator and its drift monitor declare what the lead replays
    (`@collective`): every method that runs a collective on the
    distributed tier or changes what every rank keeps, and nothing the
    host does alone."""
    from nngp_tpu_torch.serve import DriftMonitor, Estimator, LeadEstimator

    marked = {n for n in dir(Estimator)
              if getattr(getattr(Estimator, n), "collective", False)}
    assert marked == {"predict", "predict_interval", "extend_with_lines",
                      "forget_with_lines", "grow_inducing",
                      "record_feedback", "calibrate_uncertainty",
                      "relearn_hyperparams", "warmup", "save", "load_model"}
    assert DriftMonitor.reset.collective
    stub = _Stub()
    stub.drift_monitor = DriftMonitor()
    stub.encode = lambda lines: lines     # unmarked: rank 0's own
    with LeadEstimator(stub) as lead:
        assert lead.encode is stub.encode
        assert lead.drift_monitor.reset.__self__ is lead
        assert lead.drift_monitor.warmup == stub.drift_monitor.warmup
        stub.drift_monitor.n = 5
        lead.drift_monitor.reset()
    assert stub.drift_monitor.n == 0
