"""Minimal self-contained XLSX reader/writer (no openpyxl dependency).

The reference's zero-shot annotation pipeline reads annotator Excel sheets
through pandas+openpyxl (reference scripts/parse_zeroshot_test_data.py);
the port depends on neither, so this module implements the small subset of
the OOXML spreadsheet format those sheets need: one worksheet, shared or
inline strings, numbers, and blanks. XLSX is a zip of XML parts — nothing
here is format-guesswork, just SpreadsheetML. (A copy of
``whisper_ipa_tpu/utils/xlsx.py``.)

Reader: first sheet -> list of rows (cells are str, float, or None).
Writer: list of rows -> a minimal valid .xlsx (inline strings).
"""

from __future__ import annotations

import re
import zipfile
from typing import List, Optional, Union
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

Cell = Union[str, float, None]

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def _col_index(ref: str) -> int:
    """'C7' -> 2 (zero-based column index)."""
    col = 0
    for ch in ref:
        if ch.isalpha():
            col = col * 26 + (ord(ch.upper()) - ord("A") + 1)
        else:
            break
    return col - 1


def read_xlsx(path: str) -> List[List[Cell]]:
    """Parse the first worksheet into a dense list of rows."""
    with zipfile.ZipFile(path) as z:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.iter(f"{_NS}si"):
                shared.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
        sheet_names = sorted(
            n for n in z.namelist()
            if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)
        )
        if not sheet_names:
            raise ValueError(f"no worksheet found in {path}")
        root = ET.fromstring(z.read(sheet_names[0]))

    rows: List[List[Cell]] = []
    n_cols = 0
    for row_el in root.iter(f"{_NS}row"):
        row: List[Cell] = []
        for c in row_el.iter(f"{_NS}c"):
            idx = _col_index(c.get("r", ""))
            if idx < 0:
                idx = len(row)
            while len(row) <= idx:
                row.append(None)
            ctype = c.get("t", "n")
            v = c.find(f"{_NS}v")
            if ctype == "s":  # shared string
                row[idx] = shared[int(v.text)] if v is not None else None
            elif ctype == "inlineStr":
                is_el = c.find(f"{_NS}is")
                row[idx] = (
                    "".join(t.text or "" for t in is_el.iter(f"{_NS}t"))
                    if is_el is not None
                    else None
                )
            elif ctype == "str":  # formula cached string
                row[idx] = v.text if v is not None else None
            else:  # number / general
                row[idx] = float(v.text) if v is not None and v.text else None
        rows.append(row)
        n_cols = max(n_cols, len(row))
    for row in rows:
        row.extend([None] * (n_cols - len(row)))
    return rows


def _cell_ref(row: int, col: int) -> str:
    name = ""
    col += 1
    while col:
        col, rem = divmod(col - 1, 26)
        name = chr(ord("A") + rem) + name
    return f"{name}{row + 1}"


def write_xlsx(path: str, rows: List[List[Cell]]) -> None:
    """Write rows as a minimal single-sheet workbook (inline strings)."""
    cells_xml = []
    for r, row in enumerate(rows):
        parts = [f'<row r="{r + 1}">']
        for c, val in enumerate(row):
            if val is None:
                continue
            ref = _cell_ref(r, c)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                parts.append(f'<c r="{ref}"><v>{val}</v></c>')
            else:
                parts.append(
                    f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">'
                    f"{escape(str(val))}</t></is></c>"
                )
        parts.append("</row>")
        cells_xml.append("".join(parts))
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main"><sheetData>'
        + "".join(cells_xml)
        + "</sheetData></worksheet>"
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/'
        'relationships"><sheets>'
        '<sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets></workbook>'
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
        '2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships/worksheet" '
        'Target="worksheets/sheet1.xml"/></Relationships>'
    )
    root_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
        '2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships/officeDocument" '
        'Target="xl/workbook.xml"/></Relationships>'
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
        'content-types">'
        '<Default Extension="rels" ContentType="application/vnd.'
        'openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/'
        'vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
        'worksheet+xml"/></Types>'
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", root_rels)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


def read_xlsx_records(path: str) -> List[dict]:
    """First row as header -> list of {column: value} dicts."""
    rows = read_xlsx(path)
    if not rows:
        return []
    header = [str(h) if h is not None else f"col{i}"
              for i, h in enumerate(rows[0])]
    return [dict(zip(header, row)) for row in rows[1:]]
