"""The port's GUI apps on matplotlib (any backend, Agg included), each a
thin shell over the library call a script would make
(picasso_tpu/gui): the render window with its panels, the movie browser
and the locs filter, and the secondary apps. Apps whose actions run on a
device take ``device`` (the card by default)."""

from picasso_torch.gui.viewers import (  # noqa: F401
    FilterApp,
    LocalizeApp,
    RenderApp,
)
from picasso_torch.gui.panels import (  # noqa: F401
    ChannelsPanel,
    DisplaySettingsPanel,
    InfoPanel,
)
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
