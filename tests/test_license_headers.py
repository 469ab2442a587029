# SPDX-License-Identifier: Apache-2.0
"""Every Python source file carries an SPDX license identifier.

Counterpart of the reference's ``test/_license/header_check.py``.
"""

import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN = ("nvalchemiops_tpu", "tests", "benchmarks", "examples")


def _py_files():
    out = []
    for top in SCAN:
        for dirpath, _, files in os.walk(os.path.join(ROOT, top)):
            out.extend(
                os.path.join(dirpath, f) for f in files if f.endswith(".py")
            )
    out.append(os.path.join(ROOT, "bench.py"))
    out.append(os.path.join(ROOT, "chip_smoke.py"))
    return sorted(out)


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_spdx_header(path):
    with open(path) as f:
        head = f.read(512)
    assert "SPDX-License-Identifier: Apache-2.0" in head, (
        f"{os.path.relpath(path, ROOT)} missing SPDX header"
    )


def test_public_docstring_coverage():
    """>= 95% of module-level public functions/classes carry docstrings
    (counterpart of the reference's interrogate gate, pyproject:141-156)."""
    import ast
    import pathlib

    tot = doc = 0
    missing = []
    for p in pathlib.Path(ROOT, "nvalchemiops_tpu").rglob("*.py"):
        tree = ast.parse(p.read_text())
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and \
                    not node.name.startswith("_"):
                tot += 1
                if ast.get_docstring(node):
                    doc += 1
                else:
                    missing.append(f"{p}:{node.name}")
    assert doc / tot >= 0.95, (doc, tot, missing)
