"""GPS L1 C/A constants and ICD-GPS-200 scale factors.

Capability parity with the reference simulator's constant set
(plutogpssim.h:12-78, plutogpssim.c:40-45). Values are kept numerically
identical to the reference so that quantization (LNAV field packing,
Klobuchar, WGS-84 geometry) reproduces the same bit patterns / samples.
"""

# --- Simulation shape limits -------------------------------------------------
MAX_SAT = 32          # satellites in a RINEX file          (plutogpssim.h:18)
MAX_CHAN = 12         # simultaneously simulated channels   (plutogpssim.h:21)
USER_MOTION_SIZE = 3000   # max user-motion points @ 10 Hz  (plutogpssim.h:25)

N_SBF = 5             # subframes per frame                 (plutogpssim.h:29)
N_DWRD_SBF = 10       # 30-bit words per subframe           (plutogpssim.h:32)
N_DWRD = (N_SBF + 1) * N_DWRD_SBF  # word buffer: prev SF5 + 5 subframes

CA_SEQ_LEN = 1023     # C/A code chips per 1 ms period      (plutogpssim.h:38)

EPHEM_ARRAY_SIZE = 13  # max ephemeris sets per brdc file   (plutogpssim.h:78)

# --- Time --------------------------------------------------------------------
SECONDS_IN_WEEK = 604800.0
SECONDS_IN_HALF_WEEK = 302400.0
SECONDS_IN_DAY = 86400.0
SECONDS_IN_HOUR = 3600.0
SECONDS_IN_MINUTE = 60.0

# --- Powers of two (ICD-GPS-200 LNAV scale factors, plutogpssim.h:46-57) -----
POW2_M5 = 0.03125
POW2_M19 = 1.907348632812500e-6
POW2_M29 = 1.862645149230957e-9
POW2_M31 = 4.656612873077393e-10
POW2_M33 = 1.164153218269348e-10
POW2_M43 = 1.136868377216160e-13
POW2_M55 = 2.775557561562891e-17
POW2_M50 = 8.881784197001252e-016
POW2_M30 = 9.313225746154785e-010
POW2_M27 = 7.450580596923828e-009
POW2_M24 = 5.960464477539063e-008

# --- Earth / orbit model (plutogpssim.h:59-67) --------------------------------
GM_EARTH = 3.986005e14
OMEGA_EARTH = 7.2921151467e-5
PI = 3.1415926535898  # NOTE: the reference's truncated pi, used on purpose

WGS84_RADIUS = 6378137.0
WGS84_ECCENTRICITY = 0.0818191908426

R2D = 57.2957795131

# --- Signal (plutogpssim.h:69-76) ---------------------------------------------
SPEED_OF_LIGHT = 2.99792458e8
LAMBDA_L1 = 0.190293672798365

CARR_FREQ = 1575.42e6     # GPS L1 carrier
CODE_FREQ = 1.023e6       # C/A chipping rate
CARR_TO_CODE = 1.0 / 1540.0

# --- Defaults (plutogpssim.c:43-45, 2260-2276) ---------------------------------
TX_SAMPLE_FREQ = 3_000_000    # reference default sample rate (c:43)
EPOCH_RATE_HZ = 10            # range/Doppler solve cadence
BLOCK_SECONDS = 0.1           # one synthesis block
NAV_UPDATE_SECONDS = 30       # nav-message / allocation cadence

# Default static location: Tokyo (plutogpssim.c:2266-2268)
DEFAULT_LLH_DEG = (35.681298, 139.766247, 10.0)

# Path-loss reference numerator (plutogpssim.c:2678)
PATH_LOSS_NUMERATOR = 20200000.0
