"""CSV tables without pandas.

The JAX package writes its tables with ``pd.DataFrame(...).to_csv(index=
False)`` and reads them back with ``pd.read_csv``: the training history
(reference ``train.py:190-196``), the lambda sweep
(``findLambda.py:118-120``), the cross-model report
(``evaluationMetrics.py:85-92``). The port does not depend on pandas: it
writes and reads the same files here, and the raw dataset files: a table is
a dict of equal-length columns, as ``pd.DataFrame(dict)`` takes it;
``rows_to_columns`` turns a list of row dicts (``pd.DataFrame(list_of_dicts)``)
into one. ``read_table`` reads a file as ``pd.read_csv`` does (a separator of
one or more characters, an encoding, a header row or given names) into
typed numpy columns. ``read_csv`` reads back the tables the port writes,
strictly (a row of another length raises). ``to_markdown`` writes a
table as ``DataFrame.to_markdown(index=False)`` lays out its cells.

Each column is written as pandas writes its inferred dtype:

- only ints (bools excluded): plain integers;
- ints and floats, or any NaN: floats by their shortest repr, NaN as an
  empty field, so 1 is written ``1.0`` beside a float;
- only bools: ``True`` / ``False``;
- anything else: ``str`` of each value, NaN as an empty field.

Fields holding the separator, a quote or a line break are quoted as the
``csv`` module's ``QUOTE_MINIMAL`` does; lines end in ``\\n``. A list cell is
written as ``str(list)``, as pandas writes it.
"""
from __future__ import annotations

import csv
import io
import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

Columns = Dict[str, List]


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))


def _is_float(v) -> bool:
    return isinstance(v, (float, np.floating))


def _is_nan(v) -> bool:
    return _is_float(v) and math.isnan(v)


def _float_cell(v) -> str:
    v = float(v)
    return "" if math.isnan(v) else repr(v)


def _is_numeric_array(values) -> bool:
    return isinstance(values, np.ndarray) and (values.dtype.kind in "iu"
                                               or values.dtype == np.float64)


def _column_cells(values: Sequence) -> List[str]:
    """One column's fields, formatted by its inferred dtype."""
    if _is_numeric_array(values):
        # numpy columns in bulk: ints as ints, floats by their shortest repr
        if values.dtype.kind == "f":
            return ["" if v != v else repr(v) for v in values.tolist()]
        return list(map(str, values.tolist()))
    values = list(values)
    if all(_is_int(v) for v in values):
        return [str(int(v)) for v in values]
    if all(_is_int(v) or _is_float(v) for v in values):
        return [_float_cell(v) for v in values]
    if all(isinstance(v, (bool, np.bool_)) for v in values):
        return [str(bool(v)) for v in values]
    return ["" if _is_nan(v) else str(v) for v in values]


def rows_to_columns(rows: Sequence[Mapping]) -> Columns:
    """Row dicts as columns, in the order keys first appear (NaN where a
    row lacks a key), as ``pd.DataFrame(rows)`` builds them."""
    names: List[str] = []
    for row in rows:
        names.extend(n for n in row if n not in names)
    return {n: [row.get(n, math.nan) for row in rows] for n in names}


def to_csv(columns: Mapping[str, Sequence], sep: str = ",") -> str:
    """The table as ``pd.DataFrame(columns).to_csv(index=False, sep=sep)``
    writes it."""
    names = list(columns)
    lengths = {len(columns[n]) for n in names}
    if len(lengths) > 1:
        raise ValueError(f"columns of unequal length: {sorted(lengths)}")
    cells = [_column_cells(columns[n]) for n in names]
    out = io.StringIO()
    writer = csv.writer(out, delimiter=sep, lineterminator="\n")
    writer.writerow(names)
    writer.writerows(zip(*cells))
    return out.getvalue()


def to_markdown(columns: Mapping[str, Sequence]) -> str:
    """The table as a pipe table with the header and the cells that
    ``pd.DataFrame(columns).to_markdown(index=False)`` writes (tabulate's
    "pipe" format): floats in the "g" format, everything else by ``str``;
    number columns right-aligned and others left, each as wide as its widest
    cell and at least two past its name. tabulate also lines up the decimal
    points within a float column, which this does not: the cells are the
    same, the bytes may differ."""
    names = list(columns)
    cells = [[format(v, "g") if _is_float(v) else str(v) for v in columns[n]] for n in names]
    right = [all(_is_int(v) or _is_float(v) for v in columns[n]) for n in names]
    widths = [max([len(n) + 2] + [len(c) for c in col]) for n, col in zip(names, cells)]

    def line(fields):
        return "| " + " | ".join(f.rjust(w) if r else f.ljust(w)
                                 for f, w, r in zip(fields, widths, right)) + " |"

    rule = "|" + "|".join("-" * (w + 1) + ":" if r else ":" + "-" * (w + 1)
                          for w, r in zip(widths, right)) + "|"
    return "\n".join([line(names), rule] + [line(row) for row in zip(*cells)])


def write_csv(path: str, columns: Mapping[str, Sequence], sep: str = ",") -> None:
    with open(path, "w", newline="") as f:
        f.write(to_csv(columns, sep))


def _parse(field: str):
    if field == "":
        return math.nan
    try:
        return int(field)
    except ValueError:
        pass
    try:
        return float(field)
    except ValueError:
        return field


def read_csv(path: str) -> Columns:
    """A table this module (or pandas) wrote, as columns typed the way
    ``pd.read_csv`` infers them: a column of integers stays int, a numeric
    column with a float or an empty field is float (empty = NaN), any other
    column keeps its strings (empty = NaN)."""
    with open(path, newline="") as f:
        records = list(csv.reader(f))
    if not records:
        raise ValueError(f"{path}: empty CSV")
    names, body = records[0], records[1:]
    if any(len(r) != len(names) for r in body):
        raise ValueError(f"{path}: rows of unequal length")
    columns: Columns = {}
    for j, name in enumerate(names):
        values = [_parse(r[j]) for r in body]
        if all(_is_int(v) for v in values):
            columns[name] = values
        elif all(_is_int(v) or _is_float(v) for v in values):
            columns[name] = [float(v) for v in values]
        else:
            columns[name] = [v if _is_nan(v) else r[j] for v, r in zip(values, body)]
    return columns


#: ``pd.read_csv``'s default ``na_values``: a field equal to one of these is NaN
NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])
_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")


def _records(text: str, sep: str) -> List[List[str]]:
    """The file's rows of fields, blank lines skipped. A one-character
    separator reads as pandas' C parser does: a field that opens with ``"``
    is quoted, may hold the separator and line breaks, ``""`` inside it is
    one quote, and what follows its closing quote up to the separator is
    appended. A longer separator is a plain split of each line, as pandas'
    python engine splits by a regex separator, with no quoting."""
    if len(sep) == 1:
        rows = csv.reader(io.StringIO(text, newline=""), delimiter=sep, quotechar='"',
                          doublequote=True, strict=False)
        return [r for r in rows if r and not (len(r) == 1 and r[0].strip(" \t") == "")]
    lines = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
    return [line.split(sep) for line in lines if line]


def _plain_numbers(fields) -> bool:
    """Python's int()/float() also take ``1_000`` and non-ASCII digits;
    pandas does not. Checked on the fields joined, in one pass."""
    text = "".join(fields)
    return text.isascii() and "_" not in text


def _typed_column(fields: List[str]) -> np.ndarray:
    """One column typed as ``pd.read_csv`` infers it: int64 when every field
    is an integer; float64 when every field is numeric or NaN (so an int
    column with an empty cell is float); bool when every field is a boolean
    word; else objects, the fields' strings with NaN for the NA words."""
    na = np.fromiter((f in NA_STRINGS for f in fields), dtype=bool, count=len(fields))
    vals = np.asarray([f for f, n in zip(fields, na) if not n], dtype=object)
    if vals.size == 0:
        return np.full(len(fields), np.nan)
    plain = _plain_numbers(vals)
    for dtype in (np.int64, np.float64):
        try:
            typed = vals.astype(dtype) if plain else None
        except (ValueError, OverflowError):
            typed = None
        if typed is not None:
            if not na.any():
                return typed
            out = np.full(len(fields), np.nan)
            out[~na] = typed
            return out
    out = np.empty(len(fields), dtype=object)
    if all(v in _TRUE or v in _FALSE for v in vals):
        if not na.any():
            return np.asarray([v in _TRUE for v in vals], dtype=bool)
        vals = np.asarray([v in _TRUE for v in vals], dtype=object)
    out[~na] = vals
    out[na] = np.nan
    return out


def read_table(path: str, sep: str = ",", names: Optional[Sequence[str]] = None,
               encoding: str = "utf-8") -> Dict[str, np.ndarray]:
    """A raw dataset file as ``pd.read_csv(path, sep=sep, encoding=encoding)``
    reads it (``header=None, names=names`` when ``names`` is given), as a
    dict of typed numpy columns (``_typed_column``). A row with fewer fields
    than names is padded with NaN; one with more raises."""
    with open(path, encoding=encoding, newline="") as f:
        records = _records(f.read(), sep)
    if names is None:
        if not records:
            raise ValueError(f"{path}: no header row")
        names, records = records[0], records[1:]
    names = list(names)
    width = len(names)
    for r in records:
        if len(r) > width:
            raise ValueError(f"{path}: expected {width} fields, saw {len(r)}")
        if len(r) < width:
            r.extend([""] * (width - len(r)))
    columns = list(zip(*records)) if records else [()] * width
    return {name: _typed_column(list(col)) for name, col in zip(names, columns)}


def as_str(values: np.ndarray) -> List:
    """``pd.Series(values).astype(str).tolist()`` under pandas 3: NaN stays
    NaN (a float), everything else becomes ``str`` of the value."""
    return [v if isinstance(v, float) and math.isnan(v) else str(v) for v in values.tolist()]
