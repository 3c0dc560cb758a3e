"""What the benchmark imports: no module whose top-level name (compared
whole) is JAX's, flax's or the JAX package's; the reference imports nothing
of the program either."""

import ast
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "svc_inference_pipeline_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_harness_imports_no_jax():
    files = [p for p in PB.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for p in files:
        assert not top_level_imports(p) & FORBIDDEN, p


def test_reference_imports_nothing_of_the_program():
    for p in (PB / "reference").rglob("*.py"):
        names = top_level_imports(p)
        assert not names & (FORBIDDEN | {"svc_inference_pipeline_tpu_torch"}), p
        assert names <= {"__future__", "json", "math", "struct", "typing", "numpy", "torch", "portbench"}, p


def test_whole_name_comparison(monkeypatch):
    """The run's own check of ``sys.modules``: the port's name begins with
    the JAX package's, so only a whole top-level name counts."""
    import sys

    sys.path.insert(0, str(PB.parent))
    from portbench import harness

    monkeypatch.setitem(sys.modules, "svc_inference_pipeline_tpu_torch.fake_sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "svc_inference_pipeline_tpu.fake_sub", sys)
    monkeypatch.setitem(sys.modules, "jax.fake_sub", sys)
    assert harness.forbidden_modules() == ["jax", "svc_inference_pipeline_tpu"]
