"""Result formatting: table / csv / json."""

from __future__ import annotations

import io
import json

from query_engine_tpu_torch.columnar.batch import ColumnBatch


def format_table(batch: ColumnBatch, max_rows: int = 100) -> str:
    names = [f.name.rsplit(".", 1)[-1] for f in batch.schema]
    rows = batch.to_pylist()[:max_rows]
    cells = [[("NULL" if v is None else str(v)) for v in r] for r in rows]
    widths = [
        max(len(n), *(len(r[i]) for r in cells)) if cells else len(n)
        for i, n in enumerate(names)
    ]
    sep = "+-" + "-+-".join("-" * w for w in widths) + "-+"
    out = [sep]
    out.append("| " + " | ".join(n.ljust(w) for n, w in zip(names, widths)) + " |")
    out.append(sep)
    for r in cells:
        out.append("| " + " | ".join(c.ljust(w) for c, w in zip(r, widths)) + " |")
    out.append(sep)
    total = batch.num_rows
    shown = len(rows)
    tail = f"{total} row(s)" + (f", showing {shown}" if shown < total else "")
    out.append(tail)
    return "\n".join(out)


def format_csv(batch: ColumnBatch) -> str:
    import csv

    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow([f.name.rsplit(".", 1)[-1] for f in batch.schema])
    for r in batch.to_pylist():
        w.writerow(["" if v is None else v for v in r])
    return buf.getvalue().rstrip("\n")


def format_json(batch: ColumnBatch) -> str:
    names = [f.name.rsplit(".", 1)[-1] for f in batch.schema]
    rows = [dict(zip(names, r)) for r in batch.to_pylist()]
    return json.dumps(rows, indent=2, default=str)


def render(batch: ColumnBatch, fmt: str, max_rows: int = 100) -> str:
    if fmt == "csv":
        return format_csv(batch)
    if fmt == "json":
        return format_json(batch)
    return format_table(batch, max_rows)
