"""The port stands alone: importing it loads neither JAX, flax nor the TPU
package, and its sources name none of them; `chip_smoke.py` imports none of
them (it names the TPU kernel it replaces, by path, in its report)."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
from tests.test_torch_suite_env import port_test_env  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "mosfhet_tpu")


def test_import_loads_no_forbidden_module():
    code = ("import sys, mosfhet_torch, mosfhet_torch.bridge, "
            "mosfhet_torch.keyswitch, mosfhet_torch.bootstrap_ga, "
            "mosfhet_torch.ops.pbs_kernel, mosfhet_torch.ops._build, "
            "mosfhet_torch.parallel.mesh, mosfhet_torch.apps.leveled_lut, "
            "mosfhet_torch.apps.ufhe, mosfhet_torch.io, mosfhet_torch.native, "
            "mosfhet_torch.refrng, mosfhet_torch.parallel.dist_ntt, "
            "mosfhet_torch.parallel.multihost, mosfhet_torch.parallel.dryrun, "
            "mosfhet_torch.utils.profiling, mosfhet_torch.utils.roofline\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# The one line that may name the TPU package: the container's magic string,
# which both packages write and check, so that a file of either loads in
# the other.
MAGIC_LINE = ("mosfhet_torch/io.py", 'MAGIC = "mosfhet_tpu"')


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT) for p in (ROOT / "mosfhet_torch").rglob("*")
    if p.suffix in (".py", ".cu", ".cuh")), ids=str)
def test_port_source_names_no_forbidden_module(path):
    text = (ROOT / path).read_text()
    if str(path) == MAGIC_LINE[0]:
        assert text.splitlines().count(MAGIC_LINE[1]) == 1
        text = text.replace(MAGIC_LINE[1], "", 1)
    hits = re.findall(r"\b(?:jax|flax|mosfhet_tpu)\b", text, re.IGNORECASE)
    assert not hits, f"{path} names {sorted(set(hits))}"


def test_chip_smoke_imports_no_forbidden_module():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            names = [a.value for a in node.args
                     if isinstance(a, ast.Constant) and isinstance(a.value, str)]
        else:
            continue
        assert not any(n.split(".")[0] in FORBIDDEN for n in names), names
    assert not re.search(r"\b(?:jax|flax)\b",
                         (ROOT / "chip_smoke.py").read_text(), re.IGNORECASE)
