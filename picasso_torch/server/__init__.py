"""Monitoring server over the localization summary database
(picasso_tpu/server; picasso/server/: a Streamlit shell routing to
Status/History/Compare/Watcher/Preview pages over the SQLite database
that ``localize.add_file_to_db`` writes).

The query layer (``db``) and the folder watcher (``watcher``) are plain
Python over sqlite3, without pandas; the Streamlit pages (``app``) need
the optional ``streamlit`` package.
"""

STREAMLIT_AVAILABLE = True
try:  # pragma: no cover - depends on the environment
    import streamlit  # noqa: F401
except ImportError:  # pragma: no cover
    STREAMLIT_AVAILABLE = False
