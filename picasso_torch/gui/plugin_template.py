"""Starting point for a picasso_torch GUI plugin.

Copy this file into ``picasso_torch/gui/plugins/`` under any name; it is
discovered the next time an app starts (this copy, outside that folder,
is not). The contract mirrors the reference framework's plugin system
(reference plugin_template.py): a ``Plugin`` class built with the app
window, whose ``execute()`` runs once at startup.
"""

from __future__ import annotations


class Plugin:
    def __init__(self, window):
        # Which app this plugin extends: "render", "localize", "filter"
        self.name = "render"
        self.window = window

    def execute(self):
        """Called once when the app opens. Register actions here, e.g.
        window.add_plugin_action(label, callback) to add a keyboard/menu
        hook, or interact with window.locs / window.view directly."""
        self.window.add_plugin_action("Example plugin action", self.run)

    def run(self):
        print("Hello from a picasso_torch plugin!")
