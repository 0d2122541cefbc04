"""Seeded draws on the device, and string dictionaries built in bulk.

Every draw of a generator comes from one `torch.Generator` on the device the
tables are made on, seeded from `--seed`, in a fixed order: the same seed on
the same kind of device gives the same tables. Large columns are drawn in a
few calls of millions of values; strings are int32 codes into a sorted
dictionary, and only a dictionary's values are ever made as Python strings.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Draw:
    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.g = torch.Generator(device=self.device)
        # any whole number: torch takes seeds in [0, 2^64)
        self.g.manual_seed(int(seed) % (1 << 64))

    def ints(self, lo: int, hi: int, n: int) -> torch.Tensor:
        """n int64 values uniform in [lo, hi)."""
        return torch.randint(lo, hi, (n,), generator=self.g,
                             device=self.device, dtype=torch.int64)

    def pick(self, options: Sequence[str], n: int):
        """(int32 codes, sorted dictionary) of n values drawn uniformly from
        `options`."""
        return self.codes(self.ints(0, len(options), n), options)

    def codes(self, raw: torch.Tensor, options: Sequence[str]):
        """(int32 codes, sorted dictionary) of options[raw]."""
        dictionary = np.asarray(sorted(options), dtype=object)
        rank = torch.as_tensor(
            np.searchsorted(dictionary, np.asarray(options, dtype=object)),
            dtype=torch.int32, device=self.device)
        return rank[raw], dictionary

    def shuffle(self, values: torch.Tensor) -> torch.Tensor:
        perm = torch.randperm(len(values), generator=self.g,
                              device=self.device)
        return values[perm]


def digits(values: np.ndarray, width: int) -> np.ndarray:
    """uint8 [n, width]: the zero-padded decimal digits of each value."""
    values = np.asarray(values, dtype=np.int64)
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((values[:, None] // pw) % 10 + ord("0")).astype(np.uint8)


def strings(parts) -> np.ndarray:
    """Object array of str, row i the concatenation of each part's row i: a
    part is a bytes literal (the same in every row) or a uint8 [n, w]."""
    n = next(len(p) for p in parts if not isinstance(p, bytes))
    cols = [np.broadcast_to(np.frombuffer(p, dtype=np.uint8), (n, len(p)))
            if isinstance(p, bytes) else p for p in parts]
    raw = np.ascontiguousarray(np.concatenate(cols, axis=1))
    return raw.view(f"S{raw.shape[1]}")[:, 0].astype(str).astype(object)


def numbered(prefix: str, values: np.ndarray, width: int) -> np.ndarray:
    """prefix + each value zero-padded to `width` digits; for distinct
    values in ascending order the strings come out sorted."""
    return strings([prefix.encode(), digits(values, width)])
