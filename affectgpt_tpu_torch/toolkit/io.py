"""CSV/NPZ IO helpers (toolkit/utils/read_files.py parity).

Port of affectgpt_tpu/toolkit/io.py without pandas: CSVs are read with
`data/datasets.read_csv` (the values `pandas.read_csv` gives) and written
by `write_rows_csv`, byte for byte what `pd.DataFrame(rows).to_csv(path,
index=False)` writes: the columns in the order their keys first appear, an
empty cell for a missing value (None, NaN or a key a row lacks), integers
as integers unless their column also holds a float or a missing value
(then as floats, "1.0"), floats in their shortest repr (float32 values in
float32's), anything else by `str`, quoted as the `csv` module quotes.
"""

from __future__ import annotations

import csv
import math
from typing import Dict, List, Sequence

import numpy as np

from affectgpt_tpu_torch.data.datasets import read_csv


def _missing(value) -> bool:
    return value is None or (isinstance(value, (float, np.floating)) and math.isnan(value))


def _is_bool(value) -> bool:
    return isinstance(value, (bool, np.bool_))


def _is_int(value) -> bool:
    return isinstance(value, (int, np.integer)) and not _is_bool(value)


def _column_texts(values: list) -> List[str]:
    """One column's cells as pandas writes the dtype it infers for them."""
    na = [_missing(v) for v in values]
    present = [v for v, missing in zip(values, na) if not missing]
    numeric = present and all(_is_int(v) or isinstance(v, (float, np.floating))
                              for v in present)
    if numeric and all(_is_int(v) for v in present) and not any(na):
        return [str(int(v)) for v in values]
    if numeric:
        ftype = np.float32 if all(isinstance(v, np.float32) for v in present) else np.float64
        return ["" if missing else str(ftype(v)) for v, missing in zip(values, na)]
    return ["" if missing else str(v) for v, missing in zip(values, na)]


def write_rows_csv(csv_path: str, rows: Sequence[dict], columns: Sequence = ()) -> None:
    """`pd.DataFrame(rows).to_csv(csv_path, index=False)` (see the module
    docstring); `columns` come first, in their order (the columns of a
    frame built from a dict of columns, which it keeps with no row)."""
    columns = list(columns)
    for row in rows:
        columns.extend(k for k in row if k not in columns)
    absent = object()
    texts = [_column_texts([None if row.get(k, absent) is absent else row[k] for row in rows])
             for k in columns]
    with open(csv_path, "w", newline="") as handle:
        if not columns:  # an empty frame: pandas writes one empty line
            handle.write("\n")
            return
        writer = csv.writer(handle, lineterminator="\n")
        writer.writerow([str(c) for c in columns])
        for r in range(len(rows)):
            writer.writerow([col[r] for col in texts])


def func_read_key_from_csv(csv_path: str, key: str) -> List:
    return [row[key] for row in read_csv(csv_path)]


def func_write_key_to_csv(csv_path: str, names: Sequence, name2value: Dict, keys: Sequence[str]) -> None:
    rows = []
    for name in names:
        value = name2value[name]
        if not isinstance(value, (list, tuple)):
            value = [value]
        rows.append({"name": name, **dict(zip(keys, value))})
    write_rows_csv(csv_path, rows)


def read_csv_as_map(csv_path: str, key: str = "name", value: str = "value") -> Dict:
    return {row[key]: row[value] for row in read_csv(csv_path)}


def read_npz_corpus(npz_path: str, split: str) -> Dict[str, dict]:
    """label npz {split}_corpus dict access (the format every label file uses)."""
    return np.load(npz_path, allow_pickle=True)[split].tolist()


def write_name2value_npz(npz_path: str, name2value: Dict) -> None:
    np.savez_compressed(
        npz_path,
        filenames=list(name2value),
        fileitems=[name2value[n] for n in name2value],
    )


def read_name2value_npz(npz_path: str) -> Dict:
    data = np.load(npz_path, allow_pickle=True)
    return dict(zip(data["filenames"].tolist(), data["fileitems"].tolist()))
