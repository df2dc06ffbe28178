"""Physical and signal-structure constants for supported GNSS signals.

Re-design of the reference's constants layer
(reference: src/constants/gps_property_constants.rs:3-30). Unlike the
reference, constants here are plain Python floats/ints consumed at trace
time — they become XLA compile-time constants, never device scalars.

Multi-constellation properties (Galileo E1, BeiDou B1I, GLONASS L1OF) have
no counterpart in the reference implementation (its README claims them,
reference README.md:2, but only GPS L1 C/A exists); they are part of this
framework's extended surface (BASELINE.md config ladder 3-4).
"""

SPEED_OF_LIGHT_M_S = 299_792_458.0

# ---------------------------------------------------------------------------
# GPS L1 C/A  (reference: src/constants/gps_property_constants.rs:3-9)
# ---------------------------------------------------------------------------
GPS_L1_FREQ_HZ = 1_575_420_000.0
GPS_L1_CA_CODE_RATE_CHIPS_PER_S = 1.023e6
GPS_L1_CA_CODE_LENGTH_CHIPS = 1023
GPS_L1_CA_CODE_PERIOD_S = 1e-3
GPS_L1_CA_CODE_PERIOD_MS = 1
GPS_NUM_PRN = 32

# Navigation message structure
# (reference: src/constants/gps_property_constants.rs:11-27)
GPS_CA_PREAMBLE_BITS = (1, -1, -1, -1, 1, -1, 1, 1)  # 10001011 in +/-1
GPS_CA_BIT_PERIOD_MS = 20
GPS_CA_TELEMETRY_RATE_BITS_PER_S = 50
GPS_WORD_BITS = 30
GPS_SUBFRAME_BITS = 300
GPS_SUBFRAME_MS = 6000
GPS_TOW_BITS = 17
GPS_PARITY_BITS = 6

# GPS time
GPS_SECONDS_PER_WEEK = 604_800.0

# WGS-84 / orbital constants (for nav/orbits.py; the reference's legacy
# src/satellite.rs:20-93 hardcodes these inline)
GM_EARTH_M3_S2 = 3.986005e14          # WGS-84 value of Earth's GM (GPS ICD)
OMEGA_E_DOT_RAD_S = 7.2921151467e-5   # Earth rotation rate
F_RELATIVISTIC = -4.442807633e-10     # s/sqrt(m), relativistic clock corr.
# per-constellation geodesy (Galileo OS ICD 5.1.1; BDS ICD 3.2 CGCS2000;
# GLONASS ICD PZ-90.11)
GAL_GM_M3_S2 = 3.986004418e14
GAL_OMEGA_E_DOT_RAD_S = 7.2921151467e-5
BDS_GM_M3_S2 = 3.986004418e14
BDS_OMEGA_E_DOT_RAD_S = 7.2921150e-5
GLO_GM_M3_S2 = 3.986004418e14         # PZ-90.11 geocentric constant
GLO_OMEGA_E_DOT_RAD_S = 7.292115e-5
GLO_J2 = 1.0826257e-3                 # second zonal harmonic
GLO_A_E_M = 6_378_136.0               # PZ-90 Earth radius

# ---------------------------------------------------------------------------
# Galileo E1 (OS)  — extended surface, no reference counterpart
# ---------------------------------------------------------------------------
GAL_E1_FREQ_HZ = 1_575_420_000.0
GAL_E1_CODE_RATE_CHIPS_PER_S = 1.023e6
GAL_E1_CODE_LENGTH_CHIPS = 4092
GAL_E1_CODE_PERIOD_S = 4e-3
GAL_E1_CODE_PERIOD_MS = 4
GAL_E1_BOC_SUBCARRIER_RATE_HZ = 1.023e6   # BOC(1,1) square subcarrier
GAL_E1C_SECONDARY_LENGTH = 25
GAL_NUM_PRN = 50

# ---------------------------------------------------------------------------
# BeiDou B1I — extended surface, no reference counterpart
# ---------------------------------------------------------------------------
BDS_B1I_FREQ_HZ = 1_561_098_000.0
BDS_B1I_CODE_RATE_CHIPS_PER_S = 2.046e6
BDS_B1I_CODE_LENGTH_CHIPS = 2046
BDS_B1I_CODE_PERIOD_S = 1e-3
BDS_B1I_CODE_PERIOD_MS = 1
BDS_NH_CODE = (0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0)
BDS_NUM_PRN = 37

# ---------------------------------------------------------------------------
# GLONASS L1OF (FDMA) — extended surface, no reference counterpart
# ---------------------------------------------------------------------------
GLO_L1_BASE_FREQ_HZ = 1_602_000_000.0
GLO_L1_CHANNEL_SPACING_HZ = 562_500.0
GLO_L1_CODE_RATE_CHIPS_PER_S = 0.511e6
GLO_L1_CODE_LENGTH_CHIPS = 511
GLO_L1_CODE_PERIOD_S = 1e-3
GLO_L1_CODE_PERIOD_MS = 1
GLO_FREQ_CHANNELS = tuple(range(-7, 7))  # k in [-7, 6]


def glonass_l1_carrier_hz(k: int) -> float:
    """Carrier frequency of GLONASS L1OF FDMA channel ``k``."""
    return GLO_L1_BASE_FREQ_HZ + k * GLO_L1_CHANNEL_SPACING_HZ
