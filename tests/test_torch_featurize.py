"""The port's own copies of the host modules against the JAX package's
originals: `nngp_tpu_torch.featurize` (stats, parser, encoders),
`nngp_tpu_torch.eval` (q-error, splits, calibration) and the g++-built
native encoder `nngp_tpu_torch.native`. Encodings, splits and profiles
must be equal bit for bit on the committed forest and synth6 workloads.
Also: no module of the port, and not `chip_smoke.py`, imports the JAX
package (an AST scan; `test_torch_serve_frontends.py` runs the port with
`nngp_tpu` blocked)."""

import ast
import os
import subprocess

import numpy as np
import pytest

import nngp_tpu.eval.calibration as J_cal
import nngp_tpu.eval.qerror as J_qe
import nngp_tpu.eval.splits as J_splits
from nngp_tpu.data.workload import load_multi_join_workload as jax_multi
from nngp_tpu.data.workload import load_single_table_workload as jax_single
from nngp_tpu.featurize.join import MultiJoinEncoder as JMultiJoinEncoder
from nngp_tpu.featurize.stats import load_stats_dir as j_load_stats_dir
from nngp_tpu_torch import native
from nngp_tpu_torch.data.workload import (load_multi_join_workload,
                                          load_single_table_workload)
from nngp_tpu_torch.eval import calibration, qerror, splits
from nngp_tpu_torch.featurize.join import MultiJoinEncoder
from nngp_tpu_torch.featurize.stats import TableStats, load_stats_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(REPO, "workloads", "forest_data")
SYNTH6 = os.path.join(REPO, "workloads", "synth6_join_data")
SYNTH6_STATS = os.path.join(REPO, "workloads", "synth6_stats")


@pytest.fixture(scope="module")
def forest():
    """(port, jax) single-table workloads: (X, Y, infos, encoder) each."""
    return (load_single_table_workload(FOREST, name="forest"),
            jax_single(FOREST, name="forest"))


@pytest.fixture(scope="module")
def synth6():
    return (load_multi_join_workload(SYNTH6, schema_name="synth6"),
            jax_multi(SYNTH6, schema_name="synth6"))


def _lines(path):
    out = []
    for fname in sorted(os.listdir(path)):
        with open(os.path.join(path, fname)) as f:
            out += [ln.strip() for ln in f if ln.strip()]
    return out


def _same_workload(got, want):
    x, y, infos, enc = got
    jx, jy, jinfos, jenc = want
    assert x.dtype == jx.dtype and y.dtype == jy.dtype
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert [tuple(i) for i in infos] == [tuple(i) for i in jinfos]
    assert enc.feat_dim == jenc.feat_dim


def test_forest_encoding_is_the_jax_encoding_bit_for_bit(forest):
    (x, _, _, enc), (_, _, _, jenc) = forest
    _same_workload(*forest)
    assert x.shape == (18000, 20)
    assert enc.stats.to_json() == jenc.stats.to_json()
    np.testing.assert_array_equal(enc.col_scale, jenc.col_scale)
    assert enc.max_abs_bound() == jenc.max_abs_bound()


@pytest.mark.parametrize("chunk_norm", [False, True])
def test_synth6_encoding_is_the_jax_encoding_bit_for_bit(synth6, chunk_norm):
    if chunk_norm:
        got = load_multi_join_workload(SYNTH6, schema_name="synth6",
                                       chunk_norm=True)
        want = jax_multi(SYNTH6, schema_name="synth6", chunk_norm=True)
    else:
        got, want = synth6
    _same_workload(got, want)
    enc, jenc = got[3], want[3]
    assert got[0].shape == (18000, 61)
    assert enc.all_join_triples == jenc.all_join_triples
    np.testing.assert_array_equal(enc.col_scale, jenc.col_scale)
    assert enc.max_abs_bound() == jenc.max_abs_bound()


def test_cardless_serving_lines_encode_as_the_jax_encoder():
    stats = load_stats_dir(SYNTH6_STATS)
    enc = MultiJoinEncoder(stats)
    jenc = JMultiJoinEncoder(j_load_stats_dir(SYNTH6_STATS))
    lines = ["@".join(ln.split("@")[:-1]) for ln in _lines(SYNTH6)[::37]]
    got = enc.encode_batch([enc.parse_line_without_card(ln) for ln in lines])
    want = jenc.encode_batch([jenc.parse_line_without_card(ln)
                              for ln in lines])
    np.testing.assert_array_equal(got, want)


def test_stats_round_trip_through_either_package():
    for t in load_stats_dir(SYNTH6_STATS):
        back = TableStats.from_json(t.to_json())
        assert back == t and back.addresses == t.addresses
    jstats = j_load_stats_dir(SYNTH6_STATS)
    assert [t.to_json() for t in load_stats_dir(SYNTH6_STATS)] == \
        [t.to_json() for t in jstats]


def _native_or_skip():
    if not native.is_available():
        pytest.skip("g++ is unavailable: the native encoder cannot build")


def test_native_multi_join_encoder_matches_the_jax_python_encoder(synth6):
    _native_or_skip()
    (_, _, _, enc), (jx, _, jinfos, jenc) = synth6
    lines = _lines(SYNTH6)
    x, cards, nt, npd, nj = native.FastEncoder(enc.tables).encode_multi(
        "\n".join(lines))
    np.testing.assert_array_equal(x, jx)
    parsed = [jenc.parse_line(ln) for ln in lines]
    np.testing.assert_array_equal(cards, [p[3] for p in parsed])
    np.testing.assert_array_equal(nt, [i.num_table for i in jinfos])
    np.testing.assert_array_equal(npd, [i.num_predicates for i in jinfos])
    np.testing.assert_array_equal(nj, [i.num_joins for i in jinfos])


def test_native_single_table_encoder_matches_the_jax_python_encoder(forest):
    _native_or_skip()
    (_, _, _, enc), (jx, jy, _, _) = forest
    lines = _lines(FOREST)
    x, cards, npd = native.FastEncoder([enc.stats]).encode_single(
        "\n".join(lines))
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(np.log2(cards).reshape(-1, 1), jy)


def test_native_library_is_cached_by_source_hash(tmp_path, monkeypatch):
    """The port builds its own `csrc/fastenc.cpp` into
    `.build/nngp_tpu_torch/`, keyed by the source's hash; without g++ it
    reports unavailable and leaves no temporary file behind."""
    from nngp_tpu_torch.native import fastenc

    path = fastenc.library_path()
    assert os.path.dirname(path).endswith(os.path.join(".build",
                                                       "nngp_tpu_torch"))
    assert os.path.basename(path).startswith("libfastenc_")
    assert fastenc._SRC == os.path.join(REPO, "nngp_tpu_torch", "csrc",
                                        "fastenc.cpp")
    monkeypatch.setattr(fastenc, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(fastenc.subprocess, "run",
                        _raise(FileNotFoundError("g++")))
    assert fastenc._compile() is None
    assert os.listdir(tmp_path) == []


def _raise(exc):
    def fn(*args, **kwargs):
        raise exc
    return fn


def test_native_source_is_the_repo_level_source():
    """The copy differs from `native/fastenc.cpp` only in its header
    comment: the code below it is the same."""
    def body(path):
        with open(path) as f:
            text = f.read()
        return text[text.index("// Schema wire format"):]

    assert body(os.path.join(REPO, "nngp_tpu_torch", "csrc",
                             "fastenc.cpp")) == \
        body(os.path.join(REPO, "native", "fastenc.cpp"))


@pytest.mark.parametrize("kwargs", [
    {}, {"max_num_train": 1000}, {"train_frac": 0.2, "test_frac": 0.6},
    {"train_frac": 0.8, "test_frac": 0.2, "seed": 3},
])
def test_splits_are_the_jax_splits(forest, kwargs):
    x, y, infos, _ = forest[0]
    got = splits.train_test_val_split(x, y, all_query_infos=infos, **kwargs)
    want = J_splits.train_test_val_split(x, y, all_query_infos=infos,
                                         **kwargs)
    for g, w in zip(got, want):
        if g is None or isinstance(g, list):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)


def test_uneven_split_is_the_jax_split(synth6):
    x, y, infos, _ = synth6[0]
    got = splits.uneven_train_test_split(x, y, infos, "num_table",
                                         skew_ratio=0.3)
    want = J_splits.uneven_train_test_split(x, y, infos, "num_table",
                                            skew_ratio=0.3)
    for g, w in zip(got, want):
        if g is None or isinstance(g, list):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("keys", ["", "num_table", "num_predicates",
                                  "num_table,num_joins"])
def test_qerror_profiles_are_the_jax_profiles(synth6, keys):
    _, _, infos, _ = synth6[0]
    errors = np.random.default_rng(4).normal(0.0, 3.0, len(infos))
    got = qerror.PredictionStatistics().get_prediction_details(
        errors, infos, keys, printer=None)
    want = J_qe.PredictionStatistics().get_prediction_details(
        errors, infos, keys, printer=None)
    assert got == want
    assert qerror.format_profile(qerror.qerror_profile(errors)) == \
        J_qe.format_profile(J_qe.qerror_profile(errors))
    np.testing.assert_array_equal(qerror.symmetric_qerror(errors),
                                  J_qe.symmetric_qerror(errors))
    np.testing.assert_array_equal(
        qerror.PredictionStatistics().get_permutation_index(infos, keys),
        J_qe.PredictionStatistics().get_permutation_index(infos, keys))


def test_calibration_is_the_jax_calibration():
    rng = np.random.default_rng(5)
    y, mu = rng.normal(size=500), rng.normal(size=500)
    sd = np.abs(rng.normal(size=500))
    sd[::50] = 0.0
    assert calibration.calibration_table(y, mu, sd) == \
        J_cal.calibration_table(y, mu, sd)
    table = calibration.calibration_table(y, mu, sd, num_intervals=20)
    assert calibration.calibration_mae(table) == J_cal.calibration_mae(table)
    assert calibration.fit_std_scale(y, mu, sd) == \
        J_cal.fit_std_scale(y, mu, sd)
    scores = calibration.conformal_scores(y, mu, sd)
    np.testing.assert_array_equal(scores, J_cal.conformal_scores(y, mu, sd))
    for alpha in (0.05, 0.1, 0.5, 0.999):
        assert calibration.conformal_quantile(scores, alpha) == \
            J_cal.conformal_quantile(scores, alpha)


def _python_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "nngp_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports_of_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in ("nngp_tpu", "jax", "jaxlib")]
    return found


def test_the_port_imports_nothing_of_the_jax_package():
    sources = _python_sources()
    assert len(sources) > 40
    assert os.path.join(REPO, "nngp_tpu_torch", "gp", "nystrom.py") in sources
    offenders = {os.path.relpath(p, REPO): _imports_of_the_jax_package(p)
                 for p in sources}
    assert {p: f for p, f in offenders.items() if f} == {}


def test_the_import_scan_finds_an_import_of_the_jax_package(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nimport nngp_tpu.eval\n"
                   "def f():\n    from nngp_tpu.featurize import stats\n"
                   "from nngp_tpu_torch import ops\n")
    assert _imports_of_the_jax_package(str(bad)) == [
        (2, "nngp_tpu.eval"), (4, "nngp_tpu.featurize")]


def test_the_import_scan_finds_an_import_of_jax(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\nimport jax.numpy as jnp\n"
                   "from jaxlib import xla_client\n")
    assert _imports_of_the_jax_package(str(bad)) == [
        (2, "jax.numpy"), (3, "jaxlib")]


def test_the_copies_are_tracked_by_git():
    """The copies are committed sources, not build outputs."""
    out = subprocess.run(
        ["git", "check-ignore", "nngp_tpu_torch/csrc/fastenc.cpp",
         "nngp_tpu_torch/featurize/join.py", "nngp_tpu_torch/eval/splits.py"],
        cwd=REPO, capture_output=True, text=True)
    assert out.stdout == ""
