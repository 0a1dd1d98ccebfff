"""What the benchmark may import: nothing of JAX or of the JAX package
``repro`` anywhere under ``port_bench/``, and nothing of the program
(``repro_torch``) in its plain reference; names compared whole by their
top level, since ``repro_torch`` begins with ``repro``."""
import ast
import sys
from pathlib import Path

import pytest

from port_bench import bench

BENCH = Path(__file__).resolve().parents[1]


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(under: Path) -> list[Path]:
    return sorted(under.rglob("*.py"))


def test_port_bench_imports_no_jax_and_no_jax_package():
    for path in sources(BENCH):
        found = top_level_imports(path) & set(bench.FORBIDDEN)
        assert not found, f"{path.relative_to(BENCH)} imports {found}"


def test_port_bench_reference_imports_nothing_of_the_program():
    for path in sources(BENCH / "reference"):
        found = {n for n in top_level_imports(path) if n == "repro_torch"}
        assert not found, f"{path.relative_to(BENCH)} imports the program"


def test_port_bench_import_scan_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.training\nfrom reprox import y\n"
                   "import repro.models\nfrom jax import numpy\n")
    names = top_level_imports(src)
    assert names & set(bench.FORBIDDEN) == {"repro", "jax"}


@pytest.mark.parametrize("loaded, flagged", [
    (["repro_torch", "repro_torch.training"], []),
    (["repro.models.transformer"], ["repro.models.transformer"]),
    (["jaxlib.xla_client", "flax"], ["flax", "jaxlib.xla_client"]),
    (["reprox", "jaxtyping"], []),
])
def test_port_bench_run_refuses_loaded_jax_by_whole_names(loaded, flagged,
                                                          monkeypatch):
    fake = {name: object() for name in loaded}
    monkeypatch.setattr(sys, "modules", {**{k: v for k, v in
                                            sys.modules.items()
                                            if k.split(".")[0] not in
                                            bench.FORBIDDEN}, **fake})
    assert bench.forbidden_modules() == flagged
