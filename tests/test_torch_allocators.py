"""The port's allocators (`openr_tpu_torch.allocators`) against
`openr_tpu`'s (oracle `tests/test_prefix_manager_allocators.py`).

The same node names, seeds and KvStore state allocate the same values
and prefixes in both packages: a first proposal from the name's hash,
the walk past values other nodes already own, the override of a claim
the node wins on the CRDT tie-break, a concession after a collision
(another node claims the value at a higher version), sequential
elections in one store, a restart from the persisted index, and the
prefix allocator's advertisement.  Runs are threaded; every wait polls
converged state against a deadline.
"""

from __future__ import annotations

import ipaddress
import time
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("port", "ref")


def pkg(name: str) -> SimpleNamespace:
    if name == "port":
        from openr_tpu_torch import allocators, types
        from openr_tpu_torch.allocators import prefix_allocator, range_allocator
        from openr_tpu_torch.config_store import PersistentStore
        from openr_tpu_torch.kvstore import InProcessTransport, KvStore, KvStoreClientInternal
        from openr_tpu_torch.runtime.eventbase import OpenrEventBase
        from openr_tpu_torch.runtime.queue import ReplicateQueue
    else:
        from openr_tpu import allocators, types
        from openr_tpu.allocators import prefix_allocator, range_allocator
        from openr_tpu.config_store import PersistentStore
        from openr_tpu.kvstore import InProcessTransport, KvStore, KvStoreClientInternal
        from openr_tpu.runtime.eventbase import OpenrEventBase
        from openr_tpu.runtime.queue import ReplicateQueue
    return SimpleNamespace(
        name=name, alloc=allocators, pa=prefix_allocator, ra=range_allocator,
        T=types, PersistentStore=PersistentStore, InProcessTransport=InProcessTransport,
        KvStore=KvStore, Client=KvStoreClientInternal, OpenrEventBase=OpenrEventBase,
        ReplicateQueue=ReplicateQueue,
    )


P = {name: pkg(name) for name in PACKAGES}


def wait_for(cond, timeout=20.0, interval=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


class Node:
    """One KvStore, an event base and its KvStoreClientInternal."""

    def __init__(self, p, name: str):
        self.p, self.name = p, name
        self.fabric = p.InProcessTransport()
        self.updates, self.syncs = p.ReplicateQueue(), p.ReplicateQueue()
        self.kvstore = p.KvStore(name, self.updates, self.syncs, None,
                                 transport=self.fabric.bind(name))
        self.fabric.register(name, self.kvstore)
        self.kvstore.run()
        self.evb = p.OpenrEventBase(name=f"evb-{name}")
        self.evb.run()
        self.client = p.Client(self.evb, name, self.kvstore, self.updates.get_reader(),
                               check_persist_interval_s=60)

    def claim(self, key: str, owner: str, version: int = 1) -> None:
        """`owner`'s claim of `key`, as another node's flood would set it."""
        val = self.p.T.Value(version=version, originator_id=owner, value=owner.encode())
        self.kvstore.set_key_vals("0", {key: val})

    def owners(self, prefix: str) -> dict:
        pub = self.kvstore.dump_all("0", key_prefixes=[prefix])
        return {k: (v.value, v.version, v.originator_id) for k, v in sorted(pub.key_vals.items())}

    def stop(self):
        self.client.stop()
        for q in (self.updates, self.syncs):
            q.close()
        self.evb.stop()
        self.kvstore.stop()


@pytest.fixture
def nodes():
    made = []

    def make(p, name):
        made.append(Node(p, name))
        return made[-1]

    yield make
    for n in made:
        n.stop()


def allocate(node, name: str, rng_range, init=None, override=True, settle_s=0.05):
    """One RangeAllocator of `name` on `node`'s store, started and settled;
    its value and the allocator (stop it)."""
    got = []
    alloc = node.p.ra.RangeAllocator(
        node.evb, node.client, "0", "alloc:", name, got.append, rng_range,
        override_owner=override, settle_time_s=settle_s,
    )
    alloc.start_allocation(init)
    assert wait_for(lambda: alloc.my_value is not None), name
    return alloc.my_value, alloc, got


@pytest.mark.parametrize("seed", range(3))
def test_initial_value_from_the_name_hash(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        start = int(rng.integers(0, 1000))
        span = (start, start + int(rng.integers(0, 5000)))
        name = f"node-{int(rng.integers(0, 1 << 30)):x}"
        got = {
            n: p.ra.RangeAllocator._initial_value(
                SimpleNamespace(start=span[0], end=span[1], node_name=name))
            for n, p in P.items()
        }
        assert got["port"] == got["ref"]


@pytest.mark.parametrize("seed", range(3))
def test_index_to_prefix(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        v6 = rng.random() < 0.7
        plen = int(rng.integers(8, 64 if v6 else 24))
        alloc_len = plen + int(rng.integers(1, (128 if v6 else 32) - plen + 1))
        base = int(rng.integers(0, 1 << 62)) << (64 if v6 else 0)
        net = ipaddress.ip_network(
            ((base if v6 else int(rng.integers(0, 1 << 32))), plen), strict=False
        )
        index = int(rng.integers(0, 1 << min(alloc_len - plen, 62)))
        got = {
            n: p.pa.PrefixAllocator._index_to_prefix(
                SimpleNamespace(seed=net, alloc_len=alloc_len), index)
            for n, p in P.items()
        }
        assert got["port"] == got["ref"]


@pytest.mark.parametrize("seed", range(3))
def test_walk_past_owned_values(seed, nodes):
    """Seeded competitors own values around the name's first proposal:
    both packages walk to the same free value and leave the same keys."""
    rng = np.random.default_rng(seed)
    name = f"me-{seed}"
    span = (0, 7)
    first = P["port"].ra.RangeAllocator._initial_value(
        SimpleNamespace(start=0, end=7, node_name=name))
    taken = {(first + k) % 8 for k in range(int(rng.integers(1, 4)))}
    results = {}
    for n, p in P.items():
        node = nodes(p, name)
        for v in sorted(taken):
            # owners above the name in byte order: never overridden
            node.claim(f"alloc:{v}", f"zz-{v}")
        value, alloc, _ = allocate(node, name, span)
        results[n] = (value, node.owners("alloc:"))
        alloc.stop()
    assert results["port"] == results["ref"]
    assert results["port"][0] not in taken


def test_override_of_a_claim_won_on_tie_break(nodes):
    """A claim by a lower name is overridden (override_owner), and kept
    when the allocator does not override."""
    results = {}
    for n, p in P.items():
        for override in (True, False):
            node = nodes(p, f"mid-{override}")
            first = p.ra.RangeAllocator._initial_value(
                SimpleNamespace(start=0, end=3, node_name=f"mid-{override}"))
            node.claim(f"alloc:{first}", "aaa")
            value, alloc, _ = allocate(node, f"mid-{override}", (0, 3), override=override)
            results[(n, override)] = (value, first, node.owners("alloc:"))
            alloc.stop()
    assert results[("port", True)] == results[("ref", True)]
    assert results[("port", False)] == results[("ref", False)]
    value, first, _ = results[("port", True)]
    assert value == first


def test_concede_after_a_collision(nodes):
    """Once settled, a higher-named node claims the value at a higher
    version: the allocator reports the loss, moves to the next value and
    settles there, the same way in both packages."""
    results = {}
    for n, p in P.items():
        node = nodes(p, "bbb")
        value, alloc, got = allocate(node, "bbb", (0, 5))
        node.claim(f"alloc:{value}", "zzz", version=5)
        assert wait_for(lambda: alloc.my_value not in (None, value)), n
        assert wait_for(lambda: len(got) == 3)
        results[n] = (value, got, alloc.my_value, node.owners("alloc:"))
        alloc.stop()
    assert results["port"] == results["ref"]
    assert results["port"][1][1] is None  # the loss was reported


def test_sequential_elections_in_one_store(nodes):
    """Seeded names elect one after another in one store: the same
    distinct values in both packages."""
    rng = np.random.default_rng(3)
    names = [f"n{int(rng.integers(0, 1 << 20)):x}" for _ in range(5)]
    results = {}
    for n, p in P.items():
        node = nodes(p, "host")
        values, allocs = [], []
        for name in names:
            value, alloc, _ = allocate(node, name, (0, 6))
            values.append(value)
            allocs.append(alloc)
        results[n] = (values, node.owners("alloc:"))
        for alloc in allocs:
            alloc.stop()
    assert results["port"] == results["ref"]
    assert len(set(results["port"][0])) == len(names)


@pytest.mark.parametrize("seed_prefix,alloc_len", [("fc00::/16", 32), ("10.0.0.0/8", 24)])
def test_prefix_allocator_advertises_and_persists(seed_prefix, alloc_len, nodes, tmp_path):
    """The elected index becomes the same subprefix, the same
    PrefixUpdateRequest and the same store file; a restart re-proposes
    the persisted index."""
    results = {}
    for n, p in P.items():
        node = nodes(p, "node1")
        path = tmp_path / f"{n}.bin"
        store = p.PersistentStore(str(path))
        prefixq = p.ReplicateQueue()
        reader = prefixq.get_reader()
        alloc = p.pa.PrefixAllocator(node.evb, "node1", node.client, seed_prefix, alloc_len,
                                     prefix_updates_queue=prefixq, config_store=store)
        alloc.start()
        req = reader.get(timeout=10)
        first = (alloc.get_my_prefix(), int(req.type), req.prefixes_to_add[0].prefix,
                 store.load(p.pa.CONFIG_KEY))
        alloc.stop()
        store.close()
        # a restart on a fresh KvStore re-proposes the persisted index
        node2 = nodes(p, "node1-again")
        index = int(first[3].decode())
        store = p.PersistentStore(str(path))
        alloc = p.pa.PrefixAllocator(node2.evb, "node1", node2.client, seed_prefix, alloc_len,
                                     prefix_updates_queue=prefixq, config_store=store)
        alloc.start()
        # the callback persists the index after it sets the prefix
        assert wait_for(lambda: store.num_writes_to_disk == 1)
        prefix = alloc.get_my_prefix()
        alloc.stop()
        store.close()
        results[n] = (first, prefix, index, path.read_bytes())
        prefixq.close()
    assert results["port"] == results["ref"]
    assert results["port"][0][0] == results["port"][1]


def test_port_refuses_assign_to_interface(nodes):
    """`assign_to_interface` is taken in both packages (the test keeps the
    name it had while the port refused it): the same prefix is elected,
    and each allocator's address sync reads the kernel's links through
    its own rtnetlink socket.  The interface does not exist, so nothing
    is programmed."""
    got = {}
    for name, p in P.items():
        node = nodes(p, "node1")
        alloc = p.pa.PrefixAllocator(node.evb, "node1", node.client, "fc00::/16", 32,
                                     assign_to_interface="openr-no-such-if")
        alloc.start()
        try:
            assert wait_for(lambda: alloc.get_my_prefix() is not None)
            assert wait_for(lambda: alloc._nl is not None and not alloc._addr_worker_busy)
            got[name] = (alloc.get_my_prefix(), type(alloc._nl).__module__)
        finally:
            alloc.stop()
        assert alloc._nl is None
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == "openr_tpu_torch.nl.netlink"
    assert got["ref"][1] == "openr_tpu.nl.netlink"
