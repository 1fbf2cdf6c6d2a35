"""The port's daemon config and flags (`openr_tpu_torch.config`,
`openr_tpu_torch.main`'s flag parser) against `openr_tpu`'s.

The same flags over the same config file give byte-equal `to_wire`
configs in both packages, the same config files load to byte-equal
configs and the same bad ones fail with the same `ConfigError`
messages (oracles `tests/test_flags.py` and the config part of
`tests/test_ctrl_config_monitor.py`).  A config one package writes on
the wire the other reads back equal.  The port's parser has every
reference flag except the device pair `--use-device-spf` /
`--no-device-spf`: its daemon computes on the card.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

from torch_parity import to_ref

PACKAGES = ("port", "ref")
DEVICE_FLAGS = {"--use-device-spf", "--no-device-spf"}


def pkg(name: str) -> SimpleNamespace:
    if name == "port":
        from openr_tpu_torch import config, main, serializer
    else:
        from openr_tpu import config, main, serializer
    return SimpleNamespace(name=name, config=config, main=main, ser=serializer)


P = {name: pkg(name) for name in PACKAGES}


def wire(p, obj) -> str:
    return json.dumps(p.ser.to_wire(obj), sort_keys=True)


def both_wire(fn) -> str:
    """`fn(p)` in each package as wire JSON; equal in both, returned once."""
    got = {name: wire(p, fn(p)) for name, p in P.items()}
    assert got["port"] == got["ref"]
    return got["port"]


# -- flags (tests/test_flags.py) ----------------------------------------------

FLAG_SETS = [
    [],
    ["--node-name", "flagged", "--openr-ctrl-port", "1234", "--fib-agent-port", "60100"],
    ["--assume-drained", "--dryrun", "--enable-flood-optimization",
     "--disable-watchdog", "--decision-debounce-min-ms", "1",
     "--decision-debounce-max-ms", "5"],
    ["--tls-cert-path", "/c", "--tls-key-path", "/k", "--tls-ca-path", "/a",
     "--tls-acl-regex", "node-.*"],
    ["--tls-acl-regex", "only-acl"],
    ["--listen-addr", "127.0.0.1", "--fib-agent-host", "10.0.0.1",
     "--override-drain-state", "--enable-netlink", "--plugin-module", "x.y",
     "--config-store-path", "/var/store.bin", "-v"],
]


@pytest.mark.parametrize("argv", FLAG_SETS, ids=lambda a: " ".join(a) or "none")
def test_flags_override_config_equally(argv, tmp_path):
    path = tmp_path / "conf.json"
    path.write_text(json.dumps({"node_name": "from-config",
                                "kvstore_config": {"flood_msg_per_sec": 7}}))

    def applied(p):
        cfg = p.config.load_config(str(path))
        args = p.main.build_flag_parser().parse_args(["--config", str(path), *argv])
        p.main.apply_flag_overrides(cfg, args)
        return cfg

    out = both_wire(applied)
    assert "from-config" in out or "flagged" in out


def test_parser_has_every_reference_flag_but_the_device_pair():
    def options(p):
        return {
            s for a in p.main.build_flag_parser()._actions for s in a.option_strings
        }

    assert options(P["ref"]) - DEVICE_FLAGS == options(P["port"])
    assert DEVICE_FLAGS <= options(P["ref"])


@pytest.mark.parametrize("flag", sorted(DEVICE_FLAGS))
def test_port_parser_refuses_the_device_pair(flag, capsys):
    with pytest.raises(SystemExit):
        P["port"].main.build_flag_parser().parse_args(["--config", "/dev/null", flag])


def test_port_parser_requires_a_config():
    for p in P.values():
        with pytest.raises(SystemExit):
            p.main.build_flag_parser().parse_args([])


# -- config files and validation ----------------------------------------------

GOOD = [
    {"node_name": "node-1",
     "areas": [{"area_id": "a1", "neighbor_regexes": ["node-.*"]}],
     "openr_ctrl_port": 3018,
     "kvstore_config": {"flood_msg_per_sec": 100}},
    {"node_name": "filenode"},
    {"node_name": "n1", "tls_config": {"cert_path": "/c", "key_path": "/k", "ca_path": "/a"}},
    {"node_name": "alloc", "prefix_allocation_config":
        {"seed_prefix": "2001:db8::/48", "allocate_prefix_len": 64}},
    {"node_name": "w.1_x-2", "eor_time_s": 1.5, "enable_v4": False,
     "spark_config": {"hello_time_s": 0.3, "fastinit_hello_time_ms": 20},
     "watchdog_config": {"interval_s": 1, "max_memory_mb": 4096},
     "link_monitor_config": {"exclude_interface_regexes": ["lo"]},
     "decision_config": {"debounce_min_ms": 5, "debounce_max_ms": 20}},
    {"node_name": "ports", "openr_ctrl_port": 0, "thrift_shim_port": -1,
     "fib_agent_port": 60100, "enable_netlink": True, "plugin_module": "a.b"},
]

BAD = [
    {"node_name": ""},
    {"node_name": "bad name"},
    {"node_name": "x", "areas": [{"area_id": "1"}, {"area_id": "1"}]},
    {"node_name": "x", "areas": [{"area_id": "1", "interface_regexes": ["["]}]},
    {"node_name": "x", "areas": []},
    {"node_name": "x", "prefix_allocation_config": {"allocate_prefix_len": 64}},
    {"node_name": "x", "tls_config": {"acl_regex": "node-.*"}},
    {"node_name": "x", "tls_config": {"cert_path": "/c", "key_path": "/k",
                                      "ca_path": "/a", "acl_regex": "("}},
    {"node_name": "x", "openr_ctrl_port": 70000},
]


@pytest.mark.parametrize("data", GOOD, ids=lambda d: d["node_name"])
def test_config_files_load_equally(data, tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(data))
    both_wire(lambda p: p.config.load_config(str(path)))
    dicts = {name: p.config.config_from_dict(data).to_dict() for name, p in P.items()}
    assert dicts["port"] == dicts["ref"]
    cfgs = {name: p.config.config_from_dict(data) for name, p in P.items()}
    assert cfgs["port"].area_ids == cfgs["ref"].area_ids
    assert to_ref(cfgs["port"].spark_timers()) == cfgs["ref"].spark_timers()
    assert to_ref(cfgs["port"].spark_area_configs()) == cfgs["ref"].spark_area_configs()


@pytest.mark.parametrize("data", BAD, ids=lambda d: json.dumps(d)[:40])
def test_validation_errors_are_equal(data):
    messages = {}
    for name, p in P.items():
        with pytest.raises(p.config.ConfigError) as e:
            p.config.config_from_dict(data)
        messages[name] = str(e.value)
    assert messages["port"] == messages["ref"]


def test_config_error_is_a_value_error():
    assert issubclass(P["port"].config.ConfigError, ValueError)


def test_seeded_configs_cross_the_wire_both_ways():
    """Seeded random configs: each package's wire form is the other's,
    and each reads the other's back to an equal config."""
    rng = np.random.default_rng(12)
    for _ in range(20):
        data = {
            "node_name": f"n{int(rng.integers(0, 1000))}",
            "openr_ctrl_port": int(rng.integers(1, 65535)),
            "dryrun": bool(rng.integers(0, 2)),
            "node_label": int(rng.integers(0, 1 << 20)),
            "areas": [{"area_id": str(a)} for a in range(int(rng.integers(1, 4)))],
            "kvstore_config": {"ttl_decrement_ms": int(rng.integers(1, 10)),
                               "enable_flood_optimization": bool(rng.integers(0, 2))},
            "decision_config": {"debounce_min_ms": int(rng.integers(1, 50))},
        }
        cfgs = {name: p.config.config_from_dict(data) for name, p in P.items()}
        wires = {name: P[name].ser.to_wire(cfg) for name, cfg in cfgs.items()}
        assert json.dumps(wires["port"], sort_keys=True) == json.dumps(wires["ref"], sort_keys=True)
        assert P["ref"].ser.from_wire(wires["port"]) == cfgs["ref"]
        assert P["port"].ser.from_wire(wires["ref"]) == cfgs["port"]
