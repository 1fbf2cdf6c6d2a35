"""Spark: neighbor discovery over link-local multicast.

Port of `openr_tpu.spark` (reference: openr/spark/): hello /
handshake / heartbeat protocol with a 5-state per-neighbor FSM
(IDLE/WARM/NEGOTIATE/ESTABLISHED/RESTART), RTT measurement, area
negotiation, and graceful-restart support, over a mockable IoProvider.
"""

from .io_provider import IoProvider, MockIoProvider, UdpIoProvider
from .spark import Spark, SparkNeighState, SparkConfig, AreaConfig

__all__ = [
    "AreaConfig",
    "IoProvider",
    "MockIoProvider",
    "Spark",
    "SparkConfig",
    "SparkNeighState",
    "UdpIoProvider",
]
