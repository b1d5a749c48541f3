"""CSV tables without pandas.

The JAX package writes its tables with ``pd.DataFrame(...).to_csv(index=
False)`` and reads them back with ``pd.read_csv``: the training history
(reference ``train.py:190-196``), the lambda sweep
(``findLambda.py:118-120``), the cross-model report
(``evaluationMetrics.py:85-92``). The port does not depend on pandas: it
writes and reads the same files here. A table is a dict of equal-length
columns, as ``pd.DataFrame(dict)`` takes it; ``rows_to_columns`` turns a list
of row dicts (``pd.DataFrame(list_of_dicts)``) into one.

Each column is written as pandas writes its inferred dtype:

- only ints (bools excluded): plain integers;
- ints and floats, or any NaN: floats by their shortest repr, NaN as an
  empty field, so 1 is written ``1.0`` beside a float;
- only bools: ``True`` / ``False``;
- anything else: ``str`` of each value, NaN as an empty field.

Fields holding a comma, a quote or a line break are quoted as the ``csv``
module's ``QUOTE_MINIMAL`` does; lines end in ``\\n``.
"""
from __future__ import annotations

import csv
import io
import math
from typing import Dict, List, Mapping, Sequence

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


def _column_cells(values: Sequence) -> List[str]:
    """One column's fields, formatted by its inferred dtype."""
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


def to_csv(columns: Mapping[str, Sequence]) -> str:
    """The table as ``pd.DataFrame(columns).to_csv(index=False)`` writes it."""
    names = list(columns)
    lengths = {len(columns[n]) for n in names}
    if len(lengths) > 1:
        raise ValueError(f"columns of unequal length: {sorted(lengths)}")
    cells = [_column_cells(list(columns[n])) for n in names]
    out = io.StringIO()
    writer = csv.writer(out, lineterminator="\n")
    writer.writerow(names)
    for row in zip(*cells):
        writer.writerow(row)
    return out.getvalue()


def write_csv(path: str, columns: Mapping[str, Sequence]) -> None:
    with open(path, "w", newline="") as f:
        f.write(to_csv(columns))


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
