"""The comparison that decides `correct`: a statement's rows against the
reference's.

Two numbers come out of a statement:

- `wrong` (0 or 1): the rows differ in number, or a row has no partner
  among the reference's rows in its place whose strings, integers, dates and
  NULLs are equal and of the same type, with a float where the reference
  has a float;
- `float_gap`: the widest relative gap |got - want| / |want| of a float cell
  against its partner (0 where both are 0, inf where only the reference's
  is 0).

Rows whose ORDER BY columns (`order`, positions in the row) tie may come in
either order: the reference's rows fall into blocks of consecutive rows
whose order columns are equal (floats within TIE_RTOL), and a row of the
program's may take any partner of the block at its own position. The
configuration's `limits` say which numbers are held, and to what.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

# floats in ORDER BY columns closer than this may come in either order:
# far above any rounding of the program's or the reference's sums, far
# below the gaps between distinct keys of the generated data
TIE_RTOL = 1e-6


def _is_float(v) -> bool:
    return isinstance(v, float)


def _gap(a: float, b: float) -> float:
    if math.isnan(a) or math.isnan(b):
        return 0.0 if math.isnan(a) and math.isnan(b) else math.inf
    if a == b:
        return 0.0
    if b == 0.0 or math.isinf(a) or math.isinf(b):
        return math.inf
    return abs(a - b) / abs(b)


def _exact_equal(g: tuple, w: tuple) -> bool:
    """Every cell but the floats equal and of the same type; a float where
    the reference has one."""
    if len(g) != len(w):
        return False
    for a, b in zip(g, w):
        if _is_float(b):
            if not _is_float(a):
                return False
        elif type(a) is not type(b) or a != b:
            return False
    return True


def _row_gap(g: tuple, w: tuple) -> float:
    return max((_gap(a, b) for a, b in zip(g, w) if _is_float(b)),
               default=0.0)


def _ties(a, b) -> bool:
    if _is_float(a) and _is_float(b):
        return a == b or _gap(a, b) <= TIE_RTOL
    return type(a) is type(b) and a == b


def _blocks(want: List[tuple], order: Sequence[int]):
    """[start, end) of each run of rows whose order columns tie."""
    start = 0
    for i in range(1, len(want) + 1):
        if i == len(want) or not order or not all(
                _ties(want[i][k], want[i - 1][k]) for k in order):
            yield start, i
            start = i


def compare(got: List[tuple], want: List[tuple],
            order: Sequence[int]) -> Tuple[int, float]:
    """(wrong, float_gap) of one statement's rows."""
    if len(got) != len(want):
        return 1, 0.0
    worst = 0.0
    for start, end in _blocks(want, order):
        free = list(range(start, end))
        for g in got[start:end]:
            best, best_gap = None, math.inf
            for j in free:
                if _exact_equal(g, want[j]):
                    gap = _row_gap(g, want[j])
                    if best is None or gap < best_gap:
                        best, best_gap = j, gap
                        if gap == 0.0:
                            break
            if best is None:
                return 1, worst
            free.remove(best)
            worst = max(worst, best_gap)
    return 0, worst
