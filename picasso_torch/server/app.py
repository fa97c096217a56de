"""Streamlit monitoring pages over the port (picasso_tpu/server/app.py;
picasso/server/app.py): sidebar routing to Status / History / Compare /
Watcher / Preview over the localization summary database.

Run with: python -m picasso_torch server
(needs the optional ``streamlit`` package)."""

from __future__ import annotations

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

try:
    import streamlit as st  # noqa: E402
except ImportError as _err:  # pragma: no cover - without streamlit
    raise ImportError(
        "picasso_torch.server.app is a Streamlit script; install the"
        " optional 'streamlit' package and launch it with"
        " 'python -m picasso_torch server'. The query layer"
        " (picasso_torch.server.db) and the folder watcher"
        " (picasso_torch.server.watcher) work without Streamlit."
    ) from _err

from picasso_torch.server import db as _db  # noqa: E402


def status_page():
    st.write("# Status")
    info = _db.db_status()
    st.write(f"Database: `{info['path']}`")
    st.write(f"Entries: {info['n_entries']}")
    st.write(f"Size: {info['size_mb']:.2f} MB")


def history_page():
    st.write("# History")
    rows = _db.history()
    if not rows:
        st.info("No runs recorded yet.")
        return
    st.dataframe(rows)
    for col in ("nena_nm", "n_locs", "drift_x"):
        if col in rows[0]:
            st.line_chart([r[col] for r in rows])


def compare_page():
    st.write("# Compare")
    rows = _db.fetch_db()
    if not rows:
        st.info("No runs recorded yet.")
        return
    files = [r["filename"] for r in rows]
    a = st.selectbox("File A", files, index=0)
    b = st.selectbox("File B", files, index=min(1, len(files) - 1))
    st.dataframe(_db.compare(a, b))


def watcher_page():
    from picasso_torch.server import watcher

    st.write("# Watcher")
    path = st.text_input("Folder to watch")
    if st.button("Check now") and path:
        new, _ = watcher.check_new(path, {})
        st.write(f"{len(new)} unprocessed movie file(s):")
        for f in new:
            st.write(f"- `{f}`")
        if st.button("Process all"):
            for f in new:
                out = watcher.process_file(f)
                st.write(f"Processed -> `{out}`")


def preview_page():
    from picasso_torch import io, render

    st.write("# Preview")
    path = st.text_input("Locs file (_locs.hdf5)")
    if path and os.path.isfile(path):
        locs, info = io.load_locs(path)
        rgb, n = render.render_scene(locs, info, disp_px_size=30,
                                     blur_method="smooth")
        st.image(rgb, caption=f"{n} localizations")


PAGES = {
    "Status": status_page,
    "History": history_page,
    "Compare": compare_page,
    "Watcher": watcher_page,
    "Preview": preview_page,
}


def main():
    st.sidebar.title("picasso-torch server")
    choice = st.sidebar.radio("Navigate", list(PAGES.keys()))
    PAGES[choice]()


if __name__ == "__main__":
    main()
