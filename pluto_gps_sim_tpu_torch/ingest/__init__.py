from .motion import read_user_motion
from .rinex import RinexError, RinexResult, read_rinex2, read_rinex3
from .stations import STATIONS_V2, STATIONS_V3, Station

__all__ = [
    "read_user_motion", "read_rinex2", "read_rinex3", "RinexResult",
    "RinexError", "STATIONS_V2", "STATIONS_V3", "Station",
]
