"""LinkMonitor: interface tracking + adjacency advertisement.

Port of `openr_tpu.link_monitor` (reference: LinkMonitor,
openr/link-monitor/LinkMonitor.h:95).
"""

from .link_monitor import AdjKey, InterfaceEntry, LinkMonitor, LinkMonitorState

__all__ = ["AdjKey", "InterfaceEntry", "LinkMonitor", "LinkMonitorState"]
