"""Config: typed daemon configuration with JSON loading and validation.

Port of `openr_tpu.config` (reference: Config, openr/config/Config.{h,cpp}
over openr/if/OpenrConfig.thrift:400): a JSON file in the thrift schema's
shape becomes validated typed accessors and per-area config.  The types
register with the port's serializer under the reference's names, so
both packages read and write the same config on the wire.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Optional

from .serializer import register_type
from .spark.spark import AreaConfig, SparkConfig


class ConfigError(ValueError):
    pass


@register_type
@dataclass(slots=True)
class KvStoreConf:
    """Reference: thrift::KvstoreConfig (OpenrConfig.thrift:25)."""

    key_ttl_ms: int = -1
    ttl_decrement_ms: int = 1
    flood_msg_per_sec: int = 0  # 0 == unlimited
    flood_msg_burst_size: int = 0
    key_prefix_filters: list[str] = field(default_factory=list)
    # DUAL flood-topology optimization (reference: enable_flood_optimization
    # / is_flood_root, OpenrConfig.thrift:25 KvstoreConfig)
    enable_flood_optimization: bool = False
    is_flood_root: bool = True


@register_type
@dataclass(slots=True)
class LinkMonitorConf:
    """Reference: thrift::LinkMonitorConfig (OpenrConfig.thrift:74)."""

    linkflap_initial_backoff_ms: int = 1000
    linkflap_max_backoff_ms: int = 60000
    use_rtt_metric: bool = False
    include_interface_regexes: list[str] = field(default_factory=lambda: [".*"])
    exclude_interface_regexes: list[str] = field(default_factory=list)
    redistribute_interface_regexes: list[str] = field(default_factory=list)


@register_type
@dataclass(slots=True)
class DecisionConf:
    debounce_min_ms: int = 10
    debounce_max_ms: int = 250


@register_type
@dataclass(slots=True)
class WatchdogConf:
    """Reference: thrift::WatchdogConfig (OpenrConfig.thrift:145)."""

    interval_s: int = 20
    thread_timeout_s: int = 300
    max_memory_mb: int = 800


@register_type
@dataclass(slots=True)
class PrefixAllocationConf:
    """Reference: thrift::PrefixAllocationConfig (OpenrConfig.thrift:193)."""

    seed_prefix: str = ""
    allocate_prefix_len: int = 128
    # interface to assign the elected prefix's first address to via
    # netlink (reference: PrefixAllocator loopback address sync;
    # set_loopback_address + loopback_interface).  Empty = don't program.
    assign_to_interface: str = ""


@register_type
@dataclass(slots=True)
class SparkConf:
    hello_time_s: float = 20.0
    fastinit_hello_time_ms: float = 500.0
    keepalive_time_s: float = 2.0
    hold_time_s: float = 10.0
    graceful_restart_time_s: float = 30.0


@register_type
@dataclass(slots=True)
class AreaConf:
    area_id: str = "0"
    interface_regexes: list[str] = field(default_factory=lambda: [".*"])
    neighbor_regexes: list[str] = field(default_factory=lambda: [".*"])


@register_type
@dataclass(slots=True)
class TlsConf:
    """mTLS + peer-name ACL on the ctrl transport (reference: wangle TLS
    setup + client-CN allowlist, openr/Main.cpp:546-612; flags
    --x509_cert_path/--x509_key_path/--x509_ca_path/--tls_acl_cache...)."""

    cert_path: str = ""
    key_path: str = ""
    ca_path: str = ""
    acl_regex: str = ".*"  # allowed client certificate CommonNames


@register_type
@dataclass(slots=True)
class OpenrConfig:
    """Reference: thrift::OpenrConfig (OpenrConfig.thrift:400)."""

    node_name: str = ""
    domain: str = "openr"
    areas: list[AreaConf] = field(default_factory=lambda: [AreaConf()])
    listen_addr: str = "::1"
    openr_ctrl_port: int = 2018
    dryrun: bool = False
    enable_v4: bool = True
    enable_segment_routing: bool = True
    enable_best_route_selection: bool = False
    enable_rib_policy: bool = False
    enable_ordered_fib_programming: bool = False
    enable_watchdog: bool = True
    assume_drained: bool = False
    override_drain_state: bool = False
    eor_time_s: Optional[float] = None
    node_label: int = 0
    # thrift Binary+framed interop listener (interop.shim); 0 disables,
    # -1 binds an ephemeral port (tests)
    thrift_shim_port: int = 0
    persistent_config_store_path: str = ""
    # standalone FibService platform agent endpoint (reference: fib_port
    # gflag, Flags.cpp; 0 == use the in-process mock agent)
    fib_agent_host: str = "::1"
    fib_agent_port: int = 0
    # import path of a plugin module exposing plugin_start(PluginArgs)
    # (reference: the BGP-speaker seam, Plugin.h:23-32 + Main.cpp:501-510)
    plugin_module: str = ""
    # real kernel link/address events via rtnetlink (reference: the nl/
    # NetlinkProtocolSocket producer, Main.cpp:330-343); off by default —
    # tests and mock-fabric deployments inject events directly
    enable_netlink: bool = False
    tls_config: Optional[TlsConf] = None
    kvstore_config: KvStoreConf = field(default_factory=KvStoreConf)
    link_monitor_config: LinkMonitorConf = field(default_factory=LinkMonitorConf)
    decision_config: DecisionConf = field(default_factory=DecisionConf)
    spark_config: SparkConf = field(default_factory=SparkConf)
    watchdog_config: WatchdogConf = field(default_factory=WatchdogConf)
    prefix_allocation_config: Optional[PrefixAllocationConf] = None

    # -- validation (reference: Config::populateInternalDb, Config.h:274) ----

    def validate(self) -> "OpenrConfig":
        if not self.node_name:
            raise ConfigError("node_name is required")
        if not re.fullmatch(r"[a-zA-Z0-9._-]+", self.node_name):
            raise ConfigError(f"invalid node_name {self.node_name!r}")
        if not self.areas:
            raise ConfigError("at least one area is required")
        area_ids = [a.area_id for a in self.areas]
        if len(area_ids) != len(set(area_ids)):
            raise ConfigError("duplicate area ids")
        for area in self.areas:
            for pattern in area.interface_regexes + area.neighbor_regexes:
                try:
                    re.compile(pattern)
                except re.error as e:
                    raise ConfigError(f"bad regex {pattern!r}: {e}") from e
        if self.prefix_allocation_config is not None:
            pac = self.prefix_allocation_config
            if not pac.seed_prefix:
                raise ConfigError("prefix allocation requires seed_prefix")
        if self.tls_config is not None:
            # a present-but-incomplete TLS section must fail loudly — the
            # daemon silently starting PLAINTEXT when the operator set an
            # ACL (or a partial cert set) is a security misconfiguration
            tc = self.tls_config
            if not (tc.cert_path and tc.key_path and tc.ca_path):
                raise ConfigError(
                    "tls_config requires cert_path, key_path and ca_path"
                )
            try:
                re.compile(tc.acl_regex)
            except re.error as e:
                raise ConfigError(
                    f"bad tls acl_regex {tc.acl_regex!r}: {e}"
                ) from e
        if not (0 < self.openr_ctrl_port < 65536) and self.openr_ctrl_port != 0:
            raise ConfigError(f"bad ctrl port {self.openr_ctrl_port}")
        return self

    # -- accessors ------------------------------------------------------------

    @property
    def area_ids(self) -> tuple[str, ...]:
        return tuple(a.area_id for a in self.areas)

    def spark_area_configs(self) -> list[AreaConfig]:
        return [
            AreaConfig(
                area_id=a.area_id,
                interface_regexes=list(a.interface_regexes),
                neighbor_regexes=list(a.neighbor_regexes),
            )
            for a in self.areas
        ]

    def spark_timers(self) -> SparkConfig:
        sc = self.spark_config
        return SparkConfig(
            hello_time_s=sc.hello_time_s,
            fastinit_hello_time_s=sc.fastinit_hello_time_ms / 1000.0,
            keepalive_time_s=sc.keepalive_time_s,
            hold_time_s=sc.hold_time_s,
            graceful_restart_time_s=sc.graceful_restart_time_s,
        )

    def to_dict(self) -> dict[str, Any]:
        from .serializer import _to_jsonable

        return _to_jsonable(self)


def load_config(path: str) -> OpenrConfig:
    """Load + validate a JSON config file (reference: Config(file),
    FATAL on error — we raise ConfigError)."""
    with open(path) as f:
        data = json.load(f)
    return config_from_dict(data)


def config_from_dict(data: dict[str, Any]) -> OpenrConfig:
    from .serializer import _from_jsonable

    cfg = _from_jsonable(OpenrConfig, data)
    return cfg.validate()
