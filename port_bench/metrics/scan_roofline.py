"""Kernels (`ops/`, `csrc/`): the share of the card's memory roofline that
the fact table's scan reaches. Least time: the bytes of the fact table's
columns each statement references (the configuration's `scan`: its table,
whose rows are the configured size, and a width a column a statement, BIGINT
8), each read once, over the card's peak bandwidth (`peaks.json`); divided
by the time the card was busy in the traced window (the union of the
intervals of its kernels, copies and fills). It cannot pass 100 % unless the
bytes are counted too high."""

import json


def least_bytes(config, statements):
    """Bytes the statements must read at least, from the configuration;
    None if a statement has no widths there."""
    scan = config.get("scan")
    if not scan or any(q not in scan["bytes"] for q in statements):
        return None
    rows = int(config["sizes"][scan["table"]])
    return sum(rows * sum(scan["bytes"][q].values()) for q in statements)


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["kernel_count"] or tr["busy_s"] <= 0:
        return None
    peaks = json.loads((ctx["bench"] / "peaks.json").read_text())
    card = peaks.get(ctx["device_name"])
    least = least_bytes(ctx["config"], [r[0] for r in ctx["records"]])
    if card is None or least is None:
        return None
    return 100.0 * least / card["hbm_bytes_per_s"] / tr["busy_s"]
