from . import cacode, geodesy, gpstime, lnav, orbits, tables

__all__ = ["cacode", "geodesy", "gpstime", "lnav", "orbits", "tables"]
