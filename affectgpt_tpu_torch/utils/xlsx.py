"""Minimal .xlsx reader (stdlib only: zipfile + ElementTree).

The port's own copy of affectgpt_tpu/utils/xlsx.py. The emotion-wheel
assets ship as xlsx workbooks (wheel1..5.xlsx, synonym.xlsx) and neither
machine has openpyxl; xlsx is a zip of XML, so a short parser covers the
needed subset: one or more worksheets, shared strings, inline strings and
numbers.
"""

from __future__ import annotations

import re
import zipfile
from typing import Dict, List, Optional
from xml.etree import ElementTree

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def _column_index(cell_ref: str) -> int:
    letters = re.match(r"([A-Z]+)", cell_ref).group(1)
    idx = 0
    for ch in letters:
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def read_rows(path: str, sheet: int = 0) -> List[List[Optional[str]]]:
    """Returns the sheet as a dense list of rows of cell strings (None for
    empty cells)."""
    with zipfile.ZipFile(path) as zf:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in zf.namelist():
            root = ElementTree.fromstring(zf.read("xl/sharedStrings.xml"))
            for si in root.findall(f"{_NS}si"):
                shared.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
        sheet_names = sorted(
            n for n in zf.namelist() if re.match(r"xl/worksheets/sheet\d+\.xml$", n)
        )
        target = sheet_names[sheet]
        root = ElementTree.fromstring(zf.read(target))

    rows: List[List[Optional[str]]] = []
    max_cols = 0
    for row_el in root.iter(f"{_NS}row"):
        row: Dict[int, str] = {}
        for cell in row_el.findall(f"{_NS}c"):
            ref = cell.get("r", "A1")
            col = _column_index(ref)
            ctype = cell.get("t", "n")
            value: Optional[str] = None
            v = cell.find(f"{_NS}v")
            if ctype == "s" and v is not None:
                value = shared[int(v.text)]
            elif ctype == "inlineStr":
                is_el = cell.find(f"{_NS}is")
                if is_el is not None:
                    value = "".join(t.text or "" for t in is_el.iter(f"{_NS}t"))
            elif v is not None:
                value = v.text
            if value is not None:
                row[col] = value
        max_cols = max(max_cols, max(row) + 1 if row else 0)
        rows.append(row)  # type: ignore[arg-type]

    dense: List[List[Optional[str]]] = []
    for row in rows:
        dense.append([row.get(i) for i in range(max_cols)])  # type: ignore[union-attr]
    return dense


def read_dicts(path: str, sheet: int = 0) -> List[Dict[str, Optional[str]]]:
    """First row = header; returns list of {column: value} dicts."""
    rows = read_rows(path, sheet)
    if not rows:
        return []
    header = [h if h is not None else f"col{i}" for i, h in enumerate(rows[0])]
    return [dict(zip(header, row)) for row in rows[1:]]
