"""No module of the benchmark imports JAX, jaxlib, flax or the JAX
package (top-level names compared whole: the port's own name begins with
the JAX package's), and the reference imports nothing of the port."""

import ast
import os
import re

from portbench.lib import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "nngp_tpu"}
BENCH = os.path.join(registry.ROOT, "portbench")


def imported_top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def sources(top):
    for root, _dirs, names in os.walk(top):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(root, n)


def test_no_module_imports_jax_or_the_jax_package():
    files = list(sources(BENCH))
    assert len(files) > 20
    for path in files:
        assert not imported_top_names(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, "reference")):
        assert "nngp_tpu_torch" not in imported_top_names(path), path


JAX_BENCH = re.compile(
    r"(?<![A-Za-z0-9_])(bench\.py|BENCH_r\d|BASELINE\.json)")


def test_nothing_reads_the_jax_benchmark_files():
    for path in sources(BENCH):
        if path.endswith("test_portbench_imports.py"):
            continue
        with open(path) as f:
            assert not JAX_BENCH.search(f.read()), path


def test_the_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import nngp_tpu_torch.gp\nfrom jaxtyping import x\n")
    assert imported_top_names(str(p)) == {"nngp_tpu_torch", "jaxtyping"}
    p.write_text("from nngp_tpu.gp import fit\n")
    assert imported_top_names(str(p)) == {"nngp_tpu"}
