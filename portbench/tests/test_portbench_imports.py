"""Nothing under portbench imports JAX or the JAX package (top-level
names compared whole); the reference imports nothing of the port."""

import ast
import pathlib

import pytest

from portbench.harness.common import FORBIDDEN_MODULES, forbidden_modules

BENCH = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_whole_name_compare():
    assert forbidden_modules(["siftmetal_tpu_torch", "siftmetal_tpu_torch.sift"]) == []
    assert forbidden_modules(["siftmetal_tpu.sift.extract"]) == ["siftmetal_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib", "jaxtyping"]) == ["jax", "jaxlib"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not forbidden_modules(imported(path))
    text = path.read_text()
    for other in ("bench.py", "BENCH_r0", "benchmarks/"):
        assert other not in text or path.name.startswith("test_portbench_imports")


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {n.split(".", 1)[0] for n in imported(path)}
    assert "siftmetal_tpu_torch" not in tops and not tops & FORBIDDEN_MODULES
