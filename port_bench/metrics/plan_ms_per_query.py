"""Front end (`sql/`, `plan/`, `engine/session.py`): parse and plan ms a
statement, from `Session.last_timing` after each statement of the window."""


def read(ctx):
    records = ctx["records"]
    return sum(r[3] for r in records) / len(records) if records else None
