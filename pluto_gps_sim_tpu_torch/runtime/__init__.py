from .allocator import ChannelState, allocate_channels
from .scenario import ScenarioError, select_ephemeris_set, setup_scenario
from .scheduler import Scheduler, SuperframePlan
from .stream import IqStream

__all__ = [
    "ChannelState", "allocate_channels", "ScenarioError",
    "select_ephemeris_set", "setup_scenario", "Scheduler",
    "SuperframePlan", "IqStream",
]
