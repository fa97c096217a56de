"""Drop-in plugin loader for the port's GUI apps
(picasso_tpu/gui/plugins; picasso/gui/plugins, plugin_template.py): a
plugin is any module in this package that defines a ``Plugin`` class
taking the app window in its constructor, with ``name`` (the app it
extends: "rotation", "average", "design", ...) and ``execute()``
(called once when the app opens). A module file dropped into this
folder is found; nothing is registered.
"""

from __future__ import annotations

import importlib
import os
import pkgutil
import traceback

__all__ = ["load_plugins"]


def discover_plugin_modules() -> list[str]:
    """Module names of every plugin file in this package."""
    pkg_dir = os.path.dirname(__file__)
    return [name for _, name, is_pkg in pkgutil.iter_modules([pkg_dir])
            if not is_pkg and not name.startswith("_")]


def load_plugins(window, app_name: str, on_error=None) -> list:
    """Build and execute every plugin for ``app_name``; returns the live
    plugin objects. A broken plugin never takes the app down: its
    traceback goes to ``on_error`` (default: print) and loading goes
    on."""
    loaded = []
    for mod_name in discover_plugin_modules():
        try:
            module = importlib.import_module(f"{__name__}.{mod_name}")
            plugin_cls = getattr(module, "Plugin", None)
            if plugin_cls is None:
                continue
            plugin = plugin_cls(window)
            if getattr(plugin, "name", None) not in (None, app_name):
                continue
            plugin.execute()
            loaded.append(plugin)
        except Exception:
            (on_error or print)(f"picasso_torch plugin '{mod_name}' failed:"
                                "\n" + traceback.format_exc())
    return loaded
