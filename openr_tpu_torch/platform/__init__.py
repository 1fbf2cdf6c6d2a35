"""Platform layer: the standalone FibService agent a router's Fib module
programs routes into (port of `openr_tpu.platform`; reference:
openr/platform/ — NetlinkFibHandler served by the `platform_linux`
binary, LinuxPlatformMain.cpp)."""

from .fib_agent import (  # noqa: F401
    FibAgentServer,
    KernelRouteTable,
    SimulatedRouteTable,
    TcpFibAgent,
)
