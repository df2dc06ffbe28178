"""gnss_sdr — a GNSS software-defined receiver framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
kewei/gnss-sdr-rs (see SURVEY.md): IQ front-end conditioning, PCPS
acquisition, DLL/PLL tracking, nav-message decoding, ephemerides, and PVT,
built as batched jitted compute graphs over device meshes rather than
threads over ring buffers.
"""

__version__ = "0.1.0"

from . import constants  # noqa: F401
from .config import (  # noqa: F401
    AcqConfig,
    OutputConfig,
    ParallelConfig,
    PvtConfig,
    ReceiverConfig,
    RfConfig,
    SdrConfig,
    TrackConfig,
    from_toml,
)
