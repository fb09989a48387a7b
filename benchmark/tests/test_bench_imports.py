"""What a run loads: never ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``read_tpu`` (top-level names compared whole, so the port,
``read_tpu_torch``, is not it); and the reference loads nothing of the
port."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from benchmark import run as R

from conftest import ROOT, make_tiny_root

BENCH = os.path.join(ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
    assert len(files) > 20
    for path in files:
        bad = set(_imports(path)) & set(R.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        assert "read_tpu_torch" not in set(_imports(path)), path
    code = ("import sys, benchmark.reference.fit, benchmark.reference.unet,"
            " benchmark.reference.raster, benchmark.reference.prec;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert "read_tpu_torch" not in loaded
    assert not loaded & set(R.FORBIDDEN)


def test_the_prefix_is_not_the_package():
    assert R.forbidden_modules(["read_tpu_torch", "read_tpu_torch.render",
                                "jaxtyping", "numpy"]) == []
    assert R.forbidden_modules(["read_tpu.ops.rasterize", "jaxlib.xla",
                                "flax", "jax"]) == ["flax", "jax", "jaxlib",
                                                    "read_tpu"]


@pytest.mark.parametrize("cell", ["kitti6-view", "kitti10m-fit"])
def test_a_run_loads_neither(tmp_path, cell):
    """A whole run of each kind, traced, in a fresh interpreter."""
    root = make_tiny_root(str(tmp_path))
    code = ("import sys; sys.path.insert(0, %r);"
            "from benchmark import manifest, run as R;"
            "R.run(manifest.load(%r), %r, 2**31 + 9, 0.2, True, 'cpu');"
            "print(R.forbidden_modules());"
            "print('read_tpu_torch' in sys.modules)") % (ROOT, root, cell)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True).stdout.split()
    assert out[-2:] == ["[]", "True"]
