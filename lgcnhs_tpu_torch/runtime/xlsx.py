"""Dependency-free minimal XLSX writer.

A copy of ``lgcnhs_tpu/runtime/xlsx.py`` (pure Python; the port imports
nothing of the JAX package). The reference emits its cross-model report as
an Excel workbook with one sheet per k (``evaluationMetrics.py:94-96`` via
``pd.ExcelWriter``). The port depends on neither pandas nor openpyxl, so
``cli/evaluate.py`` always writes the workbook here, as the JAX CLI does
when openpyxl is missing: an xlsx file is a zip of OOXML parts, and the subset
needed for a rectangular table of strings/numbers is small enough to emit
directly. Numbers are written as native numeric cells, everything else as
inline strings; the output opens in Excel/LibreOffice and reads back with
any OOXML parser.
"""
from __future__ import annotations

import math
import zipfile
from typing import Dict, Sequence
from xml.sax.saxutils import escape

_XMLDECL = '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
_NS_MAIN = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
_NS_REL = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"
_NS_PKGREL = "http://schemas.openxmlformats.org/package/2006/relationships"
_NS_CT = "http://schemas.openxmlformats.org/package/2006/content-types"


def column_letter(idx: int) -> str:
    """0-based column index -> A, B, ..., Z, AA, ..."""
    out = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


def _cell_xml(ref: str, value) -> str:
    if isinstance(value, bool):  # bool is an int subclass; keep it textual
        return f'<c r="{ref}" t="inlineStr"><is><t>{value}</t></is></c>'
    if isinstance(value, (int, float)):
        # OOXML numeric cells reject nan/inf; write them as inline strings
        # (metric frames can hold NaN, e.g. F1 with zero hits)
        if math.isfinite(value):
            return f'<c r="{ref}"><v>{value!r}</v></c>'
        return f'<c r="{ref}" t="inlineStr"><is><t>{value!r}</t></is></c>'
    return (
        f'<c r="{ref}" t="inlineStr"><is><t>{escape(str(value))}</t></is></c>'
    )


def _sheet_xml(rows: Sequence[Sequence]) -> str:
    body = []
    for r, row in enumerate(rows, start=1):
        cells = "".join(
            _cell_xml(f"{column_letter(c)}{r}", v) for c, v in enumerate(row)
        )
        body.append(f'<row r="{r}">{cells}</row>')
    return (
        _XMLDECL
        + f'<worksheet xmlns="{_NS_MAIN}"><sheetData>'
        + "".join(body)
        + "</sheetData></worksheet>"
    )


def write_xlsx(path: str, sheets: Dict[str, Sequence[Sequence]]) -> None:
    """Write ``{sheet_name: rows}`` (rows = sequences of str/number cells,
    first row typically the header) as a valid minimal .xlsx workbook."""
    if not sheets:
        raise ValueError("write_xlsx needs at least one sheet")
    names = list(sheets)
    overrides = "".join(
        f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
        'ContentType="application/vnd.openxmlformats-officedocument.'
        'spreadsheetml.worksheet+xml"/>'
        for i in range(len(names))
    )
    content_types = (
        _XMLDECL
        + f'<Types xmlns="{_NS_CT}">'
        '<Default Extension="rels" ContentType="application/vnd.'
        'openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/'
        'vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        + overrides
        + "</Types>"
    )
    root_rels = (
        _XMLDECL
        + f'<Relationships xmlns="{_NS_PKGREL}">'
        f'<Relationship Id="rId1" Type="{_NS_REL}/officeDocument" '
        'Target="xl/workbook.xml"/></Relationships>'
    )
    sheet_tags = "".join(
        f'<sheet name="{escape(n)}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
        for i, n in enumerate(names)
    )
    workbook = (
        _XMLDECL
        + f'<workbook xmlns="{_NS_MAIN}" xmlns:r="{_NS_REL}">'
        f"<sheets>{sheet_tags}</sheets></workbook>"
    )
    wb_rels = (
        _XMLDECL
        + f'<Relationships xmlns="{_NS_PKGREL}">'
        + "".join(
            f'<Relationship Id="rId{i + 1}" Type="{_NS_REL}/worksheet" '
            f'Target="worksheets/sheet{i + 1}.xml"/>'
            for i in range(len(names))
        )
        + "</Relationships>"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", content_types)
        zf.writestr("_rels/.rels", root_rels)
        zf.writestr("xl/workbook.xml", workbook)
        zf.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        for i, name in enumerate(names):
            zf.writestr(f"xl/worksheets/sheet{i + 1}.xml", _sheet_xml(sheets[name]))
