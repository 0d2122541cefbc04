"""Generated tables: what a generator hands to the program and to the reference.

A `Table` holds its columns as 1-D tensors of its live rows, on the device
the generator ran on, each with a kind (`int64`, `float64`, `date32` as days
since 1970-01-01 in int32, `utf8` as int32 codes into a sorted dictionary of
str). `host()` copies a table to numpy for the reference, which never sees a
tensor. Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

KINDS = ("int64", "float64", "date32", "utf8")


@dataclass
class Column:
    name: str
    kind: str
    data: object                       # torch.Tensor (device) or np.ndarray
    dictionary: Optional[np.ndarray] = None   # sorted str values of a utf8


@dataclass
class Table:
    name: str
    num_rows: int
    columns: List[Column] = field(default_factory=list)

    def add(self, name: str, kind: str, data, dictionary=None) -> "Table":
        if kind not in KINDS:
            raise ValueError(f"{self.name}.{name}: unknown kind {kind!r}")
        if len(data) != self.num_rows:
            raise ValueError(f"{self.name}.{name}: {len(data)} values for "
                             f"{self.num_rows} rows")
        self.columns.append(Column(name, kind, data, dictionary))
        return self

    def host(self) -> "HostTable":
        return HostTable(
            self.name, self.num_rows,
            {c.name: c.data.cpu().numpy() if hasattr(c.data, "cpu")
             else np.asarray(c.data) for c in self.columns},
            {c.name: c.dictionary for c in self.columns
             if c.dictionary is not None})


@dataclass
class HostTable:
    """One table on the host: numpy columns of its live rows, strings as
    int32 codes into the column's sorted dictionary."""

    name: str
    num_rows: int
    columns: Dict[str, np.ndarray]
    dicts: Dict[str, np.ndarray]

    def code(self, column: str, value: str) -> int:
        """The code of `value` in a string column, or -1 if absent."""
        d = self.dicts[column]
        i = int(np.searchsorted(d, value))
        return i if i < len(d) and d[i] == value else -1
