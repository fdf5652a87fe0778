"""Nothing under perfbench imports JAX or the JAX package (top-level names
compared whole: `mono_vifi_tpu_torch` begins with `mono_vifi_tpu`), and
the reference imports nothing of the port."""

from __future__ import annotations

import ast
import sys

import pytest

from perfbench import harness, registry

PKG = registry.ROOT / "perfbench"


def top_level_imports(path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "mono_vifi_tpu"}


def test_reference_imports_nothing_of_the_port():
    for path in sorted((PKG / "reference").rglob("*.py")):
        assert "mono_vifi_tpu_torch" not in top_level_imports(path), path


def test_loaded_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mono_vifi_tpu_torch_fake_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake_probe", object())
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "mono_vifi_tpu", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.loaded_forbidden() == ["jax", "mono_vifi_tpu"]
