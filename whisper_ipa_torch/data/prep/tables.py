"""Delimited-text reader with ``pandas.read_csv``'s value semantics.

The JAX package reads the CommonVoice TSVs and multipa's test_data.csv
through pandas (``read_csv`` with its defaults and a separator). The port
has no pandas dependency, so this module reproduces what the callers
observe of pandas 3: the default quoting (``"``, doubled inside a quoted
field), blank lines skipped, the default missing-value strings read as
NaN, and each column typed as a whole: int where every cell is an
integer and none is missing, float where every present cell is a number
(an integer column with a missing cell is float), bool where every present
cell is a true/false word, else str. A missing cell stays NaN, also under
``astype(str)`` (pandas 3's string dtype), so callers test it with
``isna``. ``iterrows`` then gives the rows as ``DataFrame.iterrows`` does.
"""

from __future__ import annotations

import csv
import math
import re
from typing import Dict, List, Tuple

# pandas' default na_values (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(
    r"\s*[+-]?((\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|inf|infinity)\s*",
    re.IGNORECASE,
)

NAN = float("nan")


def isna(value) -> bool:
    """pandas.isna for one cell of this reader."""
    return value is None or (isinstance(value, float) and math.isnan(value))


def _type_column(cells: List[str]) -> list:
    present = [c for c in cells if c not in NA_STRINGS]
    if present and all(_INT.fullmatch(c) for c in present):
        if len(present) == len(cells):
            return [int(c) for c in cells]
        return [NAN if c in NA_STRINGS else float(int(c)) for c in cells]
    if present and all(_FLOAT.fullmatch(c) for c in present):
        return [NAN if c in NA_STRINGS else float(c) for c in cells]
    if present and all(c in _TRUE or c in _FALSE for c in present):
        return [NAN if c in NA_STRINGS else c in _TRUE for c in cells]
    return [NAN if c in NA_STRINGS else c for c in cells]


def read_table(path, sep: str = ",") -> Tuple[List[str], List[Dict]]:
    """(header, rows): each row a {column: value} dict, values typed as
    ``pandas.read_csv(path, sep=sep)`` types them."""
    with open(path, newline="", encoding="utf-8") as f:
        records = [r for r in csv.reader(f, delimiter=sep) if r]
    if not records:
        raise ValueError(f"no header in {path}")
    header, body = records[0], records[1:]
    for i, r in enumerate(body):
        if len(r) > len(header):
            raise ValueError(
                f"{path}: line {i + 2} has {len(r)} fields, the header "
                f"{len(header)}"
            )
    columns = [
        _type_column([r[j] if j < len(r) else "" for r in body])
        for j in range(len(header))
    ]
    rows = [
        {name: col[i] for name, col in zip(header, columns)}
        for i in range(len(body))
    ]
    return header, rows


def iterrows(rows: List[Dict]) -> List[Dict]:
    """The rows as ``DataFrame.iterrows`` yields them: where every column
    is numeric (int or float, not bool) and one is float, a row's ints
    become floats (the row Series takes the columns' common dtype)."""
    if not rows:
        return rows

    def kind(v):
        if isinstance(v, bool):
            return "other"
        return {int: "int", float: "float"}.get(type(v), "other")

    kinds = {k for r in rows for k in map(kind, r.values())}
    if kinds != {"int", "float"}:
        return rows
    return [{k: float(v) for k, v in r.items()} for r in rows]
