"""Plugin extension point (port of `openr_tpu.plugin`): the seam where an external route origin (the
reference's closed-source BGP speaker) attaches to a running daemon.

Reference: openr/plugin/Plugin.h:23-32 (PluginArgs{prefixUpdatesQueue,
staticRoutesUpdateQueue, routeUpdatesQueue reader, config, ssl}) with the
call site openr/Main.cpp:501-510 — started before Decision so the plugin's
origins are present for the first SPF run.

A plugin is any importable module (config.plugin_module) exposing:

    def plugin_start(args: PluginArgs) -> Any: ...
    def plugin_stop(handle: Any) -> None: ...   # optional

`plugin_start` may return a handle (threads, modules, state); the daemon
passes it back to `plugin_stop` at teardown.  Through the args a plugin
can originate prefixes (PrefixUpdateRequest -> PrefixManager), inject
static routes (DecisionRouteUpdate -> Decision/Fib overlay), and observe
every computed route delta (route_updates reader): the full BGP-speaker
contract.  The reference's examples/route_injector_plugin.py reads only
these queues, so it runs against the port's daemon as it is.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Optional

from ..runtime.queue import ReplicateQueue, RQueue


@dataclass
class PluginArgs:
    """Reference: struct PluginArgs (Plugin.h:23-30)."""

    prefix_updates_queue: ReplicateQueue  # write PrefixUpdateRequest
    static_routes_update_queue: ReplicateQueue  # write DecisionRouteUpdate
    route_updates_queue: RQueue  # read DecisionRouteUpdate deltas
    config: Any  # OpenrConfig
    node_name: str = ""


def load_plugin(module_name: str):
    """Resolve a plugin module by import path; raises ImportError with the
    module name in the message (a bad plugin_module config should fail the
    daemon loudly, mirroring the reference's link-time binding)."""
    module = importlib.import_module(module_name)
    if not callable(getattr(module, "plugin_start", None)):
        raise ImportError(
            f"plugin module {module_name!r} has no plugin_start(args)"
        )
    return module


def plugin_start(module, args: PluginArgs) -> Any:
    return module.plugin_start(args)


def plugin_stop(module, handle: Any) -> None:
    stop = getattr(module, "plugin_stop", None)
    if callable(stop):
        stop(handle)
