"""The distributed tier's command lines on the CPU: `--mesh_devices` and
`--tier distributed` of the serving demo and the active-learning CLI (one
rank in this process, and two under torchrun, also serving `--listen`
through the lead and its follower), the multi-rank dry run
`python -m nngp_tpu_torch.parallel.dryrun`. (The scan that no mesh
surface still raises as unported is in test_torch_serve_frontends.py.)
"""

import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from nngp_tpu_torch.cli import active_train, serve_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = ["--schema_name", "synth", "--stats_dir", "workloads/synth_stats",
         "--train_query_path", "workloads/synth_join_data",
         "--test_query_file", "workloads/synth_join_data/join_query_2.txt",
         "--limit", "50"]
ENV = dict(os.environ, OMP_NUM_THREADS="2")


def _first5(out):
    rows = out.split("first 5")[1].split("\n")[1:6]
    return np.asarray([r.split()[:2] for r in rows], float)


@pytest.fixture(scope="module", autouse=True)
def in_repo():
    cwd = os.getcwd()
    os.chdir(REPO)
    yield
    os.chdir(cwd)


def test_serve_demo_distributed_tier_saves_and_restores(tmp_path, capsys):
    """--mesh_devices 1 --tier distributed fits the row-sharded posterior
    and writes the JAX package's distributed checkpoint, which the next
    run restores over the mesh and predicts from unchanged. (The demo is
    fp32 on the raw synth encoding, where fp32 rounding alone moves the
    means by tenths, ROADMAP Queue C: the tiers are compared in fp64 in
    test_torch_parallel_serve.py.)"""
    ck = str(tmp_path / "ck")
    flags = ["--device", "cpu", *SYNTH, "--mesh_devices", "1", "--tier",
             "distributed"]
    serve_demo.main(flags + ["--ckpt", ck])
    first = capsys.readouterr().out
    with open(os.path.join(ck, "meta.json")) as f:
        meta = json.load(f)["distributed"]
    assert meta["mesh_size"] == 1 and meta["axis_name"] == "data"
    serve_demo.main(flags + ["--ckpt", ck])
    again = capsys.readouterr().out
    assert "predicted 50 queries" in first and "restoring" in again
    assert np.all(np.isfinite(_first5(first)))
    np.testing.assert_array_equal(_first5(again), _first5(first))


def test_active_train_over_a_mesh_matches_one_device(capsys):
    base = ["--device", "cpu", "--schema_name", "synth", "--query_path",
            "workloads/synth_join_data", "--budget", "40", "--active_iters",
            "2", "--selection", "topk", "--x64"]
    got = active_train.main(base + ["--mesh_devices", "1"])
    want = active_train.main(base)
    capsys.readouterr()
    assert [h["num_train"] for h in got] == [h["num_train"] for h in want]
    np.testing.assert_allclose([h["val_mse"] for h in got],
                               [h["val_mse"] for h in want], rtol=1e-9)


def test_serve_demo_under_torchrun_prints_once(tmp_path):
    """Two ranks under torchrun: the process group comes from the
    launcher, every rank fits its rows, and only rank 0 prints."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "nngp_tpu_torch.cli.serve_demo",
         "--device", "cpu", *SYNTH, "--mesh_devices", "2", "--ckpt",
         str(tmp_path / "ck")], cwd=REPO, env=ENV, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("predicted 50 queries") == 1
    with open(tmp_path / "ck" / "meta.json") as f:
        assert json.load(f)["distributed"]["mesh_size"] == 2


@pytest.mark.parametrize("args,ok", [(["2", "--n", "120", "--block_size",
                                       "8"], True),
                                      (["2", "--n", "120", "--block_size",
                                        "0"], False)])
def test_dryrun_exit_code(args, ok):
    """Two gloo ranks: one training step and the predicts against a plain
    fit, exit 0; a rank that fails (a zero block size) fails the run."""
    proc = subprocess.run(
        [sys.executable, "-m", "nngp_tpu_torch.parallel.dryrun", *args],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    if ok:
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["world"] == 2 and line["n_padded"] == 128
        assert line["max_rel_err"] < 1e-8
    else:
        assert proc.returncode != 0


def _listen_session(port, queries, labeled):
    """A socket client of `serve_demo --listen --feedback_mode online`:
    the queries and a malformed line, the labeled lines (one feedback
    batch of 64), `\\stats` until the extend is in, the queries again.
    Returns (replies before, replies after)."""
    def send(lines):
        with socket.create_connection(("127.0.0.1", port), timeout=60) as sk:
            f = sk.makefile("rwb")
            f.write("".join(ln + "\n" for ln in lines).encode())
            f.flush()
            sk.shutdown(socket.SHUT_WR)
            return [json.loads(raw.decode()) for raw in f]

    deadline = time.monotonic() + 120
    while True:
        try:
            before = send(queries + ["ta,tb@zz,5.0,1.0@@ta,tb,id"])
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)
    assert all(a["feedback"] == "queued" for a in send(labeled))
    while send(["\\stats"])[0]["extends"] < 1:
        assert time.monotonic() < deadline
        time.sleep(0.1)
    return before, send(queries)


def test_serve_demo_listens_over_two_ranks(tmp_path, capsys,
                                           monkeypatch):
    """torchrun of two ranks: serve_demo restores an fp64 distributed
    checkpoint written over two ranks and serves `--listen` with online
    feedback from rank 0 through the lead, rank 1 replaying its calls. It
    exits 0, prints once, and replies as the world-size-1 demo does on its
    own checkpoint of the same rows (1e-9: sums over ranks in another
    order); the malformed line's reply is an error. Both demos bind port
    0; a failure raises with the torchrun child's stderr."""
    import nngp_tpu_torch.serve as serve_pkg
    from nngp_tpu_torch.parallel import make_mesh
    from nngp_tpu_torch.serve import EstimatorSocketServer
    from tests.test_active_serve import _toy_schema_files
    from tests.torch_parallel_cases import on_ranks, save_estimator

    stats, qdir = _toy_schema_files(tmp_path)
    rng = np.random.default_rng(4)
    queries, labeled = [], []
    for i in range(72):
        xu = rng.uniform(-10, 10)
        xl = rng.uniform(-10, xu)
        line = f"ta,tb@x,{xu:.3f},{xl:.3f}@@ta,tb,id"
        if i < 8:
            queries.append(line)
        else:
            labeled.append(f"{line}@{max(1, int(1000 * (xu - xl)))}")
    pl = {"stats": [s.to_json() for s in stats], "qdir": qdir, "b": 4}
    ck1, ck2 = str(tmp_path / "ck1"), str(tmp_path / "ck2")
    save_estimator(make_mesh(1, device="cpu"), dict(pl, ckpt=ck1))
    on_ranks(2, "save_estimator", dict(pl, ckpt=ck2))
    flags = ["--device", "cpu", "--schema_name", "toy", "--train_query_path",
             qdir, "--feedback_mode", "online", "--listen_max_requests",
             str(2 * len(queries)), "--warmup_batch", "16"]

    err_path = tmp_path / "torchrun.err"
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", "nngp_tpu_torch.cli.serve_demo",
             *flags, "--ckpt", ck2, "--mesh_devices", "2", "--listen",
             "127.0.0.1:0"], cwd=REPO, env=ENV, stdout=subprocess.PIPE,
            stderr=err_file, text=True)

    def failed(what):
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        return AssertionError(f"{what} (torchrun exit {proc.returncode}); "
                              "its stderr ends: "
                              + err_path.read_text()[-3000:])

    try:
        printed = []
        for line in proc.stdout:
            printed.append(line)
            if line.startswith("serving on"):
                break
        else:
            raise failed("the two ranks never served: "
                         + "".join(printed)[-2000:])
        port = int(line.split()[2].rsplit(":", 1)[1])
        try:
            got = _listen_session(port, queries, labeled)
            out = proc.communicate(timeout=120)[0]
        except (OSError, AssertionError, subprocess.TimeoutExpired) as e:
            raise failed(f"the session on two ranks failed: {e!r}") from e
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise failed("torchrun of two ranks failed")
    out = "".join(printed) + out
    assert out.count("serving on") == out.count("shutting down") == 1
    assert "the followers replayed [" in out

    # the world-size-1 demo in this process binds port 0 too: the client
    # learns the port from the server it starts
    ports, want, errors = queue.Queue(), [], []

    class Reporting(EstimatorSocketServer):
        def __enter__(self):
            srv = super().__enter__()
            ports.put(srv.port)
            return srv

    def client():
        try:
            want.extend(_listen_session(ports.get(timeout=120), queries,
                                        labeled))
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    monkeypatch.setattr(serve_pkg, "EstimatorSocketServer", Reporting)
    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    serve_demo.main(flags + ["--ckpt", ck1, "--mesh_devices", "1",
                             "--listen", "127.0.0.1:0"])
    thread.join(timeout=120)
    capsys.readouterr()
    if errors:
        raise errors[0]
    assert len(want) == 2
    assert "ValueError" in got[0][-1]["error"]
    assert [r["mean"] for r in got[0][:-1]] != [r["mean"] for r in got[1]]
    for g, w in zip(got, want):
        g = [r for r in g if "error" not in r]
        w = [r for r in w if "error" not in r]
        assert len(g) == len(w) == len(queries)
        for key in ("mean", "std"):
            a = np.asarray([r[key] for r in g])
            b = np.asarray([r[key] for r in w])
            assert np.max(np.abs(a - b)) < 1e-9 * np.max(np.abs(b))
