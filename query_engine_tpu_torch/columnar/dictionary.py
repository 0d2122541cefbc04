"""Order-preserving string dictionaries.

The reference engine stores strings as Arrow Utf8 arrays and sorts/compares
them with Arrow kernels (reference query-executor/src/operators.rs string
paths). Variable-width data cannot live in device tensors, so every
dictionary-typed column (Utf8, Json, ...) is encoded at ingest as int32 codes
into a host-side **sorted** dictionary. Because the dictionary is sorted,
code order == lexicographic order, and ORDER BY / comparisons / GROUP BY /
joins on strings run on-device as plain int32 ops (SURVEY.md §7 hard-part #3).

Merging two dictionaries (concat across batches, join across tables,
cross-host exchange) produces the sorted union plus O(1)-gatherable remap
planes for both sides.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class Dictionary:
    """An immutable sorted dictionary of Python strings."""

    __slots__ = ("values", "_index", "_maps")

    def __init__(self, values: np.ndarray):
        # values must be sorted & unique; callers use from_values/from_sorted.
        self.values = values
        self._index: Optional[dict] = None
        self._maps: Optional[dict] = None  # map_values results by key

    @staticmethod
    def from_values(values: Sequence[str]) -> Tuple["Dictionary", np.ndarray]:
        """Build a sorted dictionary from raw values; returns (dict, codes).

        None entries get code 0 (callers carry validity separately).
        The sorted distinct values and each value's code come from a set and
        a dict, np.unique's result on an object array; values that do not
        hash (lists) take np.unique itself.
        """
        arr = ["" if v is None else v for v in values]
        try:
            uniq = sorted(set(arr))
        except TypeError:
            uniq, codes = np.unique(np.asarray(arr, dtype=object),
                                    return_inverse=True)
            return Dictionary(uniq), codes.astype(np.int32)
        index = {v: i for i, v in enumerate(uniq)}
        codes = np.fromiter(map(index.__getitem__, arr), dtype=np.int32,
                            count=len(arr))
        out = np.empty(len(uniq), dtype=object)
        out[:] = uniq
        return Dictionary(out), codes

    @staticmethod
    def from_sorted(values: np.ndarray) -> "Dictionary":
        return Dictionary(values)

    @staticmethod
    def empty() -> "Dictionary":
        return Dictionary(np.asarray([], dtype=object))

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, code: int) -> str:
        return self.values[code]

    def index(self) -> dict:
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index

    def code_of(self, value: str) -> int:
        """Code for value, or -1 if absent."""
        return self.index().get(value, -1)

    def lower_bound(self, value: str) -> int:
        """First code whose value >= `value` (for range predicates)."""
        return int(np.searchsorted(self.values, value, side="left"))

    def decode(self, codes: np.ndarray) -> np.ndarray:
        if len(self.values) == 0:
            out = np.empty(len(codes), dtype=object)
            out.fill("")
            return out
        return self.values[np.clip(codes, 0, len(self.values) - 1)]

    def merge(self, other: "Dictionary") -> Tuple["Dictionary", np.ndarray, np.ndarray]:
        """Sorted union; returns (merged, remap_self, remap_other).

        remap_X[old_code] -> new_code; gather these on-device to re-encode.
        """
        if self is other or (
            len(self) == len(other) and np.array_equal(self.values, other.values)
        ):
            ident = np.arange(len(self), dtype=np.int32)
            return self, ident, ident
        union = np.union1d(self.values, other.values)
        remap_self = np.searchsorted(union, self.values).astype(np.int32)
        remap_other = np.searchsorted(union, other.values).astype(np.int32)
        return Dictionary(union), remap_self, remap_other

    def map_values(self, fn, key=None) -> Tuple["Dictionary", np.ndarray]:
        """Apply a scalar string fn to every dictionary value (UPPER/LOWER/...).

        The result dictionary must stay sorted, so we re-sort and return a
        remap plane old_code -> new_code for the device gather. With a
        `key` naming fn, the result is kept on this dictionary: the same
        map of the same dictionary (a SUBSTRING evaluated once per IN item
        and once per query) is computed once and gives the same result
        dictionary object.
        """
        if key is not None and self._maps is not None and key in self._maps:
            return self._maps[key]
        mapped = np.asarray([fn(v) for v in self.values], dtype=object)
        uniq, inverse = np.unique(mapped, return_inverse=True)
        out = Dictionary(uniq), inverse.astype(np.int32)
        if key is not None:
            if self._maps is None:
                self._maps = {}
            self._maps[key] = out
        return out


_MERGES_KEPT = 8  # merge_many results kept on a dictionary


def merge_many(dicts: List[Dictionary]) -> Tuple[Dictionary, List[np.ndarray]]:
    """Sorted union of many dictionaries + a remap plane per input.

    The last few results are kept on the first dictionary, so the same
    merge (a UNION of the same tables, query after query) gives the same
    merged dictionary object, and a compiled program keyed by it is found
    again."""
    if not dicts:
        return Dictionary.empty(), []
    if all(d is dicts[0] for d in dicts):
        ident = np.arange(len(dicts[0]), dtype=np.int32)
        return dicts[0], [ident] * len(dicts)
    first = dicts[0]
    if first._maps is None:
        first._maps = {}
    key = ("merge_many",) + tuple(id(d) for d in dicts[1:])
    kept = first._maps.get(key)
    if kept is not None and all(a is b for a, b in zip(kept[0], dicts)):
        return kept[1], kept[2]
    union = first.values
    for d in dicts[1:]:
        union = np.union1d(union, d.values)
    merged = Dictionary(union)
    remaps = [np.searchsorted(union, d.values).astype(np.int32) for d in dicts]
    merges = [k for k in first._maps
              if isinstance(k, tuple) and k[:1] == ("merge_many",)]
    for old in merges[:max(len(merges) - _MERGES_KEPT + 1, 0)]:
        del first._maps[old]
    first._maps[key] = (tuple(dicts), merged, remaps)
    return merged, remaps
