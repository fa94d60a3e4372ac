"""What the benchmark may import: no module under slambench/ names jax,
jaxlib, flax or the JAX package (top-level names compared whole, since the
system's name begins with the JAX package's), and the reference takes
nothing of the system under test."""
import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ygz_slam_tpu"}
# The yardstick: truth, traffic, the comparison, the roofline arithmetic,
# the trace reduction and the metric readers.
REFERENCE = ["scene.py", "traffic.py", "reference.py", "roofline.py", "trace.py"]


def _tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", [BENCH / n for n in REFERENCE]
                         + sorted((BENCH / "metrics").glob("*.py"))
                         + sorted((BENCH / "judges").glob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_takes_nothing_of_the_system(path):
    assert "ygz_slam_tpu_torch" not in _tops(path)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from slambench import run

    monkeypatch.setitem(sys.modules, "ygz_slam_tpu_torch_probe", object())
    assert "ygz_slam_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ygz_slam_tpu.geometry", object())
    assert "ygz_slam_tpu" in run.forbidden_modules()
