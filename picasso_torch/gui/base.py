"""What the port's matplotlib apps share (picasso_tpu/gui/base.py): the
plugin surface, the status log and two questions they ask of a locs
array."""

from __future__ import annotations

import numpy as np

from picasso_torch.gui import plugins as _plugins


def _has(locs: np.ndarray, name: str) -> bool:
    return name in (locs.dtype.names or ())


def _n_groups(locs: np.ndarray) -> int:
    return len(np.unique(locs["group"]))


class _PluginHost:
    """Plugin surface of the apps (the reference's plugin menu in each
    PyQt6 window, picasso/gui/plugins). Plugins register actions with
    ``add_plugin_action``; an action runs by name or on F1..F12 in the
    figure."""

    def _init_plugins(self, app_name: str):
        self.plugin_actions: list[tuple[str, object]] = []
        self.plugins = _plugins.load_plugins(self, app_name)
        canvas = getattr(getattr(self, "fig", None), "canvas", None)
        if canvas is not None:
            canvas.mpl_connect("key_press_event", self._on_plugin_key)

    def add_plugin_action(self, label: str, callback) -> None:
        self.plugin_actions.append((label, callback))

    def run_plugin_action(self, label: str):
        for name, callback in self.plugin_actions:
            if name == label:
                return callback()
        raise KeyError(f"no plugin action {label!r}")

    def _on_plugin_key(self, event):
        if event.key and event.key.startswith("f") and event.key[1:].isdigit():
            idx = int(event.key[1:]) - 1
            if 0 <= idx < len(self.plugin_actions):
                self.plugin_actions[idx][1]()

    def _new_fig(self, **kwargs):
        """A figure that :meth:`close` releases."""
        import matplotlib.pyplot as plt

        fig = plt.figure(**kwargs)
        self._figs = getattr(self, "_figs", [])
        self._figs.append(fig)
        return fig

    def close(self) -> None:
        """Release the app's matplotlib figures (long scripted sessions
        would otherwise pile them up until matplotlib warns at 20)."""
        import matplotlib.pyplot as plt

        fig = getattr(self, "fig", None)
        if fig is not None:
            plt.close(fig)
            self.fig = None
        for fig in getattr(self, "_figs", []):
            plt.close(fig)
        self._figs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class StatusLog:
    """Status-bar stand-in: keeps the messages, and hands each to a
    callback or prints it."""

    def __init__(self, callback=None, echo: bool = False):
        self.messages: list[str] = []
        self.callback = callback
        self.echo = echo

    def __call__(self, message: str) -> None:
        self.messages.append(str(message))
        if self.callback is not None:
            self.callback(message)
        elif self.echo:
            print(message)

    @property
    def last(self) -> str | None:
        return self.messages[-1] if self.messages else None
