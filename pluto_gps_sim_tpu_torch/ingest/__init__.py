from .motion import read_user_motion
from .rinex import RinexError, RinexResult, read_rinex2, read_rinex3

__all__ = [
    "read_user_motion", "read_rinex2", "read_rinex3", "RinexResult",
    "RinexError",
]
