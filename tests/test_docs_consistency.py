# SPDX-License-Identifier: Apache-2.0
"""docs/benchmarks.md must carry the reference's published H100 rows.

The yardstick table in docs/benchmarks.md is rendered from BASELINE.md
(the reference's committed H100 CSVs) by benchmarks/gen_doc_tables.py;
this test re-renders it in memory and fails on any drift.
"""

import subprocess
import sys
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_benchmark_docs_match_csvs():
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks",
                                      "gen_doc_tables.py"), "--check"],
        capture_output=True, text=True, cwd=ROOT)
    assert res.returncode == 0, res.stderr + res.stdout
