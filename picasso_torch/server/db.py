"""Query layer over the localization summary database
(~/.picasso/app_0410.db, written by picasso_torch.localize
.add_file_to_db): picasso_tpu/server/db.py with sqlite3 alone. The port
imports no pandas, so a table is a list of row dicts in the table's
column order, and ``compare`` gives ``{filename: {column: value}}``."""

from __future__ import annotations

import os
import sqlite3


def _db_filename() -> str:
    # looked up at call time, so that tests and apps can repoint the DB
    from picasso_torch import localize

    return localize._db_filename()


def _read(path: str) -> tuple[list[str], list[dict]]:
    """(columns, rows) of the 'files' table; nothing where there is no
    such database or table."""
    if not os.path.isfile(path):
        return [], []
    con = sqlite3.connect(path)
    try:
        cur = con.execute("SELECT * FROM files")
        columns = [d[0] for d in cur.description]
        return columns, [dict(zip(columns, row)) for row in cur.fetchall()]
    except sqlite3.Error:
        return [], []
    finally:
        con.close()


def fetch_db() -> list[dict]:
    """The whole 'files' summary table as rows; empty if the database
    does not exist yet (picasso/server/helper.py fetch_db)."""
    return _read(_db_filename())[1]


def db_status() -> dict:
    """Summary of the database (picasso/server/status.py)."""
    path = _db_filename()
    columns, rows = _read(path)
    exists = os.path.isfile(path)
    return {"path": path, "exists": exists, "n_entries": len(rows),
            "size_mb": os.path.getsize(path) / 1e6 if exists else 0.0,
            "columns": columns}


def _missing(value) -> bool:
    return value is None or (isinstance(value, float) and value != value)


def history(sort_by: str = "entry_created") -> list[dict]:
    """Past localization summaries, the largest ``sort_by`` first and
    rows without a value last, ties in table order, as pandas'
    sort_values(ascending=False) orders them
    (picasso/server/history.py)."""
    rows = fetch_db()
    if not rows or sort_by not in rows[0]:
        return rows
    have = [r for r in rows if not _missing(r[sort_by])]
    return (sorted(have, key=lambda r: r[sort_by], reverse=True)
            + [r for r in rows if _missing(r[sort_by])])


def compare(file_a: str, file_b: str) -> dict:
    """Two file summaries side by side, ``{filename: {column: value}}``
    in table order (picasso/server/compare.py)."""
    return {r["filename"]: {k: v for k, v in r.items() if k != "filename"}
            for r in fetch_db() if r["filename"] in (file_a, file_b)}
