"""Control API: the single RPC surface fronting every module.

Port of `openr_tpu.ctrl` (reference: OpenrCtrlHandler and ThriftServer
(openr/ctrl-server/OpenrCtrlHandler.h:53-381, served on port 2018): ~60
RPCs spanning KvStore (get/set/dump/subscribe/long-poll), Decision
(routes/adjacencies/RibPolicy), Fib (routes/perf), LinkMonitor
(drain/metric control), PrefixManager (advertise/withdraw), Spark
(neighbors), and counters — over a newline-delimited JSON protocol with
server streaming.  The same server doubles as the KvStore peer transport
(the reference's thrift peer sync path, SURVEY §2.3).
"""

from .client import CtrlClient, TcpKvStoreTransport
from .server import CtrlServer, OpenrCtrlHandler

__all__ = ["CtrlClient", "CtrlServer", "OpenrCtrlHandler", "TcpKvStoreTransport"]
