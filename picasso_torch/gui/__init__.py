"""The port's GUI apps on matplotlib (any backend, Agg included), each a
thin shell over the library call a script would make
(picasso_tpu/gui). This holds the secondary apps; RenderApp,
LocalizeApp, FilterApp and the render panels are not ported yet."""

from picasso_torch.gui.apps import (  # noqa: F401
    Average3App,
    AverageApp,
    DesignApp,
    NanotronApp,
    RotationApp,
    SimulateApp,
    SpinnaApp,
    ToRawApp,
)
from picasso_torch.gui.base import StatusLog  # noqa: F401
