"""Serving a distributed Estimator from rank 0: the lead and its followers.

The JAX package has no counterpart. Its tier is single-controller: one
process builds the mesh and hands the sharded Estimator straight to the
socket server or the batcher. The port's distributed tier is SPMD, one
process a rank, and each collective method of the Estimator must run on
every rank in the same order. So rank 0 serves through `LeadEstimator`,
which sends every collective call to the other ranks before it runs the
call itself, and every other rank runs `follow`, which replays those calls
until the lead stops it. The front ends keep the behaviour of
`nngp_tpu/serve/{streaming,socket_server}.py`: they see one Estimator.

Every rank runs the same program up to the serving point (fit or restore,
calibrate, warm up), then rank 0 builds `LeadEstimator(est)` and the
others call `follow(est)`, at the same point: both make the control group
(`parallel.mesh.control_group`), a gloo group over the mesh's ranks.

Protocol on that group. The lead broadcasts one pickled message,
("call", name, args, kwargs), ("noop",) or ("stop",). After a call every
rank takes part in one MAX all-reduce of the pair (raised, did not raise):
  - (0, 1): no rank raised;
  - (1, 0): every rank raised. Encoding is deterministic and fails before
    any collective, so a malformed line fails the same way everywhere: the
    lead's caller gets the exception, the followers drop theirs;
  - (1, 1): the ranks disagree. Every rank raises a RuntimeError naming
    the call, the followers leave `follow` and the lead refuses every later
    call: a rank whose model may differ must not serve, and must not hang.
On ("stop",) every rank contributes the number of calls it replayed to one
sum; the lead checks them (`LeadEstimator.replayed`).

Which calls are replayed is declared where they are defined: the
Estimator's methods (and the drift monitor's `reset`) marked `@collective`.
The lead replays exactly the marked ones; every other attribute is read on
rank 0 alone.

Calls come from several threads (the batcher's dispatcher, the socket
server's feedback worker, the keep-alive): one lock orders the broadcasts
as the calls ran, and each calling thread sets the rank's CUDA device on
its first call. A lead idle for a quarter of the group's timeout sends a
no-op, so a server that is quiet for hours runs no rank into a timeout. At
world size 1 there is no group and the lead only passes calls through.
"""

import datetime
import threading
import time
import types
from typing import Optional

import torch
import torch.distributed as dist

from nngp_tpu_torch.parallel.mesh import (_TIMEOUT, control_group, is_lead,
                                          mesh_device)

_CALL, _NOOP, _STOP = "call", "noop", "stop"


def collective(method):
    """Mark a method that every rank of a distributed Estimator must run,
    in the same order: it runs collectives on the distributed tier, or
    changes state every rank keeps. `LeadEstimator` replays the marked
    methods of the Estimator and of its drift monitor, and no others."""
    method.collective = True
    return method


def _replayed(lead, path: str):
    """`path`'s method on every rank, bound to the lead (the front ends
    check its `__self__`, `streaming.require_lead`)."""
    def call(self, *args, **kwargs):
        return self._call(path, args, kwargs)

    call.__name__ = path.rpartition(".")[2]
    return types.MethodType(call, lead)


def _resolve(est, name: str):
    obj = est
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


class _Channel:
    """The control group's three exchanges, from rank 0 (coordinate 0 of
    the group) to every rank."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self._src = dist.get_global_rank(group, 0)

    def message(self, msg=None):
        """The lead's `msg` on every rank."""
        box = [msg]
        dist.broadcast_object_list(box, src=self._src, group=self.group)
        return box[0]

    def agree(self, name: str, err: Optional[BaseException]):
        """Raise RuntimeError on every rank unless all raised or none."""
        flags = torch.tensor([int(err is not None), int(err is None)])
        dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=self.group)
        if bool(flags.all()):
            raise RuntimeError(
                f"the ranks disagree on whether {name} raised (this rank "
                f"{'did' if err is not None else 'did not'}); their models "
                "may differ, so serving stops") from err

    def close(self, mine: int):
        """Every rank's count, in rank order; then the group is destroyed
        and released (a gloo group left to the interpreter's exit can
        abort it)."""
        out = torch.zeros(self.size, dtype=torch.int64)
        out[self.rank] = mine
        dist.all_reduce(out, group=self.group)
        dist.destroy_process_group(self.group)
        # destroy_process_group only unregisters the group: its gloo
        # worker and transport threads live while this reference does,
        # and a LeadEstimator sits in a reference cycle (it caches its
        # replayed methods, bound to itself), so without this the group
        # lived until a garbage collection, or to the interpreter's exit
        self.group = None
        return out.tolist()


def _timeout(seconds: Optional[float]) -> datetime.timedelta:
    if seconds is None:
        return _TIMEOUT
    return datetime.timedelta(seconds=float(seconds))


class LeadEstimator:
    """Rank 0's view of a distributed Estimator: every attribute read
    passes through to `est`; each `@collective` method is broadcast to the
    followers, run here, and agreed on (module docstring). Give it to `StreamingBatcher` or `EstimatorSocketServer`
    at any world size; at world size 1 it only passes calls through.

    timeout: seconds of each control-group operation, default the process
    group's; the lead sends a no-op after a quarter of it idle. Collective
    with `follow`. A context manager: leaving it, or `close()`, stops the
    followers."""

    def __init__(self, est, timeout: Optional[float] = None):
        mesh = est.mesh
        if not is_lead(mesh):
            raise ValueError("LeadEstimator runs on rank 0; every other "
                             "rank calls serve.follower.follow(est)")
        self._est = est
        self._device = (mesh_device(mesh) if mesh is not None
                        and mesh.device_type == "cuda" else None)
        timeout = _timeout(timeout)
        group = control_group(mesh, timeout)
        self._chan = _Channel(group) if group is not None else None
        self._lock = threading.Lock()
        self.calls = 0              # collective calls sent to the followers
        self.keepalives = 0
        self.replayed = None        # the followers' counts, set by close()
        self._failed = None
        self._closed = False
        self._last = time.monotonic()
        self._keepalive_s = timeout.total_seconds() / 4
        self._thread = threading.local()    # .device_set per calling thread
        self._stop = threading.Event()
        self._keeper = None
        if self._chan is not None:
            self._keeper = threading.Thread(target=self._keepalive_loop,
                                            name="nngp-lead-keepalive",
                                            daemon=True)
            self._keeper.start()

    def __getattr__(self, name):
        # only for attributes this class does not define
        if name == "_est":              # before __init__ set it
            raise AttributeError(name)
        value = getattr(self._est, name)
        if getattr(value, "collective", False):
            value = self.__dict__[name] = _replayed(self, name)
        return value

    @property
    def drift_monitor(self):
        """The Estimator's drift monitor, whose `@collective` methods are
        replayed."""
        mon = self._est.drift_monitor
        return None if mon is None else _LeadMonitor(self, mon)

    # ------------------------------------------------------------- calls
    def _call(self, name: str, args: tuple, kwargs: dict):
        if self._device is not None and not getattr(self._thread,
                                                    "device_set", False):
            torch.cuda.set_device(self._device)
            self._thread.device_set = True
        if self._chan is None:
            return _resolve(self._est, name)(*args, **kwargs)
        with self._lock:
            if self._closed or self._failed is not None:
                state = "closed" if self._closed else "stopped"
                raise RuntimeError(f"LeadEstimator is {state}: {name} "
                                   "cannot reach the followers"
                                   ) from self._failed
            self._chan.message((_CALL, name, args, kwargs))
            self.calls += 1
            err = out = None
            try:
                out = _resolve(self._est, name)(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - agreed, re-raised
                err = e
            try:
                self._chan.agree(name, err)
            except BaseException as e:
                self._failed = e
                raise
            finally:
                self._last = time.monotonic()
            if err is not None:
                raise err
            return out

    # ----------------------------------------------------------- lifetime
    def _keepalive_loop(self):
        poll = self._keepalive_s / 4
        while not self._stop.wait(poll):
            with self._lock:
                if self._closed or self._failed is not None:
                    return
                if time.monotonic() - self._last < self._keepalive_s:
                    continue
                try:
                    self._chan.message((_NOOP,))
                except Exception as e:  # noqa: BLE001 - the next call raises
                    self._failed = e
                    return
                self.keepalives += 1
                self._last = time.monotonic()

    def close(self):
        """Stop the followers and check that each replayed every call
        (`replayed`: their counts in rank order, [] at world size 1).
        Idempotent; a lead that stopped on a disagreement sends nothing."""
        self._stop.set()
        with self._lock:
            if not self._closed:
                self._closed = True
                self.replayed = []
                if self._chan is not None and self._failed is None:
                    self._chan.message((_STOP,))
                    self.replayed = self._chan.close(self.calls)[1:]
        if self._keeper is not None:
            self._keeper.join(timeout=10.0)
        if any(n != self.calls for n in self.replayed):
            raise RuntimeError(f"the followers replayed {self.replayed} of "
                               f"the lead's {self.calls} calls")
        return self.replayed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _LeadMonitor:
    """A drift monitor seen through the lead: reads pass through, its
    `@collective` methods are replayed."""

    def __init__(self, lead: LeadEstimator, mon):
        self._lead = lead
        self._mon = mon

    def __getattr__(self, name):
        value = getattr(self._mon, name)
        if getattr(value, "collective", False):
            return _replayed(self._lead, f"drift_monitor.{name}")
        return value


def follow(est, timeout: Optional[float] = None) -> int:
    """Every rank but 0: replay the lead's calls on `est` until it stops;
    returns the number of calls replayed. Collective with
    `LeadEstimator(est)` (same `timeout`). A call that raised on every rank
    is dropped here (the lead's caller sees it); a disagreement, a lost
    lead or a timeout raises, so a follower's failure fails its process."""
    mesh = est.mesh
    if is_lead(mesh):
        raise ValueError("follow runs on the ranks other than 0; rank 0 "
                         "serves through serve.follower.LeadEstimator(est)")
    chan = _Channel(control_group(mesh, _timeout(timeout)))
    n = 0
    while True:
        msg = chan.message()
        if msg[0] == _STOP:
            chan.close(n)
            return n
        if msg[0] == _NOOP:
            continue
        _, name, args, kwargs = msg
        n += 1
        err = None
        try:
            _resolve(est, name)(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - agreed on with the lead
            err = e
        chan.agree(name, err)
