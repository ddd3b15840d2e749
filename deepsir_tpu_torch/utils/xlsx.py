"""A minimal XLSX writer on the standard library (deepsir_tpu/utils/xlsx.py).

The eval harness writes its per-iteration metric tables as `metrics.xlsx`,
one worksheet per registration iteration. XLSX is a zip of small XML parts,
so this module writes the format directly: numbers as numeric cells,
headers as inline strings, non-finite numbers as blank cells. Its scope is
rectangular sheets of str headers and float rows.
"""
from __future__ import annotations

import math
import zipfile
from typing import Dict, List, Sequence
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
{sheets}</Types>"""

_SHEET_CT = ('<Override PartName="/xl/worksheets/sheet{n}.xml" ContentType='
             '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
             'worksheet+xml"/>\n')

_ROOT_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets>
{sheets}</sheets>
</workbook>"""

_WB_SHEET = '<sheet name="{name}" sheetId="{n}" r:id="rId{n}"/>\n'

_WB_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
{rels}</Relationships>"""

_WB_REL = ('<Relationship Id="rId{n}" Type="http://schemas.openxmlformats.'
           'org/officeDocument/2006/relationships/worksheet" '
           'Target="worksheets/sheet{n}.xml"/>\n')


def _col_name(idx: int) -> str:
    """0-based column index -> spreadsheet column letters (A, B, ... AA)."""
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(ord("A") + rem) + name
    return name


def _sheet_xml(header: Sequence[str], rows: Sequence[Sequence[float]]) -> str:
    out = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
           '<worksheet xmlns="http://schemas.openxmlformats.org/'
           'spreadsheetml/2006/main">\n<sheetData>\n<row r="1">']
    for c, name in enumerate(header):
        out.append(f'<c r="{_col_name(c)}1" t="inlineStr"><is><t>'
                   f"{escape(str(name))}</t></is></c>")
    out.append("</row>\n")
    for r, row in enumerate(rows, start=2):
        out.append(f'<row r="{r}">')
        for c, v in enumerate(row):
            f = float(v)
            if math.isfinite(f):
                out.append(f'<c r="{_col_name(c)}{r}"><v>{f:.10g}</v></c>')
            else:
                # NaN/inf are not valid OOXML numeric cells; write a blank
                # cell, matching pandas' ExcelWriter behaviour for NaN.
                out.append(f'<c r="{_col_name(c)}{r}"/>')
        out.append("</row>\n")
    out.append("</sheetData>\n</worksheet>")
    return "".join(out)


def write_xlsx(path: str,
               sheets: Dict[str, tuple[List[str], Sequence[Sequence[float]]]]
               ) -> None:
    """Write {sheet_name: (header, rows)} to an .xlsx file.

    Sheet order follows dict insertion order (one worksheet per registration
    iteration in the eval artifact, like the reference's ExcelWriter loop).
    """
    names = list(sheets)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES.format(
            sheets="".join(_SHEET_CT.format(n=i + 1)
                           for i in range(len(names)))))
        z.writestr("_rels/.rels", _ROOT_RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK.format(
            sheets="".join(_WB_SHEET.format(name=escape(nm), n=i + 1)
                           for i, nm in enumerate(names))))
        z.writestr("xl/_rels/workbook.xml.rels", _WB_RELS.format(
            rels="".join(_WB_REL.format(n=i + 1)
                         for i in range(len(names)))))
        for i, nm in enumerate(names):
            header, rows = sheets[nm]
            z.writestr(f"xl/worksheets/sheet{i + 1}.xml",
                       _sheet_xml(header, rows))
