# SPDX-License-Identifier: Apache-2.0
"""Render the reference's published H100 rows into docs/benchmarks.md.

The yardstick of this library is the reference's published H100 table in
``BASELINE.md``.  ``docs/benchmarks.md`` carries the same rows beside a
column for this library's numbers, which stay "to be measured here" until
a benchmark run on the card fills them.  The table between the AUTOGEN
markers is rendered from ``BASELINE.md`` by this script, and
``tests/test_docs_consistency.py`` runs it with ``--check`` so the docs
cannot drift from the yardstick.

Usage::

    python benchmarks/gen_doc_tables.py          # rewrite the table
    python benchmarks/gen_doc_tables.py --check  # exit 1 on drift
"""

import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "BASELINE.md")
DOC = os.path.join(ROOT, "docs", "benchmarks.md")
BEGIN = "<!-- AUTOGEN:reference (benchmarks/gen_doc_tables.py) -->"
END = "<!-- AUTOGEN:reference END -->"
NOT_MEASURED = "to be measured here"


def reference_rows(text):
    """(section, metric, value) for every timed H100 row of BASELINE.md."""
    rows, section = [], None
    for line in text.splitlines():
        if line.startswith("## "):
            section = line[3:].split("(")[0].strip()
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if (section and len(cells) >= 3 and cells[2] == "H100"
                and re.search(r"\d", cells[1])):
            rows.append((section, cells[0], cells[1]))
    return rows


def render(rows):
    out = ["| Section | Reference metric | H100 (reference) | This library |",
           "|---|---|---|---|"]
    out += [f"| {s} | {m} | {v} | {NOT_MEASURED} |" for s, m, v in rows]
    return "\n".join(out)


def splice(doc, body):
    a, b = doc.index(BEGIN) + len(BEGIN), doc.index(END)
    return doc[:a] + "\n" + body + "\n" + doc[b:]


def main(argv):
    with open(BASELINE) as f:
        body = render(reference_rows(f.read()))
    with open(DOC) as f:
        doc = f.read()
    new = splice(doc, body)
    if "--check" in argv:
        if new != doc:
            print("docs/benchmarks.md reference table is stale vs "
                  "BASELINE.md; run python benchmarks/gen_doc_tables.py",
                  file=sys.stderr)
            return 1
        return 0
    with open(DOC, "w") as f:
        f.write(new)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
