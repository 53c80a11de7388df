"""Cylinder (hub/spoke) fabric — versioned mailboxes, hubs, spokes.

The port of ``tpusppy/cylinders/``: the PH hub and the Lagrangian,
XhatShuffle and XhatXbar bound spokes.  The other spokes and hubs are not
ported yet (ROADMAP Queue 1 item 7).
"""

from .spcommunicator import KILL_ID, Mailbox, SPCommunicator, WindowFabric
from .spoke import (
    ConvergerSpokeType,
    InnerBoundNonantSpoke,
    InnerBoundSpoke,
    OuterBoundNonantSpoke,
    OuterBoundSpoke,
    OuterBoundWSpoke,
    Spoke,
)
from .hub import Hub, PHHub
from .lagrangian_bounder import LagrangianOuterBound
from .xhatshufflelooper_bounder import ScenarioCycler, XhatShuffleInnerBound
from .xhatxbar_bounder import XhatXbarInnerBound

__all__ = [
    "KILL_ID", "Mailbox", "SPCommunicator", "WindowFabric",
    "ConvergerSpokeType", "Spoke", "InnerBoundSpoke", "OuterBoundSpoke",
    "OuterBoundWSpoke", "InnerBoundNonantSpoke", "OuterBoundNonantSpoke",
    "Hub", "PHHub", "LagrangianOuterBound", "ScenarioCycler",
    "XhatShuffleInnerBound", "XhatXbarInnerBound",
]
