"""The port's KvStore (`openr_tpu_torch.kvstore`) against `openr_tpu`'s.

- `generate_hash`, `compare_values` and `merge_key_values` over seeded
  random Value sets (numpy `default_rng`): equal hashes, verdicts,
  deltas and final stores (as `serializer.dumps` bytes) in both packages;
- `KvStoreFilters`, the peer FSM's `get_next_state` table, and the flood
  token bucket on a scripted clock;
- 2–4 stores on `InProcessTransport`, built the same way in each
  package: full sync, 3-way sync, flooding, partitions, TTL expiry and
  decrement, areas, the client's persisted keys and TTL refresh, and the
  DUAL flood topology scenarios of `tests/test_kvstore.py` and
  `tests/test_kvstore_dual.py`.  Every store's final dump is equal byte
  for byte between the packages (a finite `ttl_ms` is time left, so it
  compares as finite), and so is each store's flood topology
  (`SptInfos`).

Threaded runs wait with deadline-bound polling and compare converged
state only.
"""

from __future__ import annotations

import itertools
import time
from types import SimpleNamespace

import numpy as np
import pytest

from torch_parity import to_ref

PACKAGES = ("port", "ref")


def pkg(name: str) -> SimpleNamespace:
    """One package's KvStore modules under common names."""
    if name == "port":
        from openr_tpu_torch import serializer, types
        from openr_tpu_torch.kvstore import client, kvstore
        from openr_tpu_torch.runtime.eventbase import OpenrEventBase
        from openr_tpu_torch.runtime.queue import ReplicateQueue
    else:
        from openr_tpu import serializer, types
        from openr_tpu.kvstore import client, kvstore
        from openr_tpu.runtime.eventbase import OpenrEventBase
        from openr_tpu.runtime.queue import ReplicateQueue
    return SimpleNamespace(
        name=name, T=types, ser=serializer, kv=kvstore, client=client,
        OpenrEventBase=OpenrEventBase, ReplicateQueue=ReplicateQueue,
    )


P = {name: pkg(name) for name in PACKAGES}


def wait_for(cond, timeout=10.0, interval=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


# -- seeded Values ------------------------------------------------------------


def random_values(rng, n: int, keys=8, with_hash=False) -> list:
    """(key, port Value) pairs over a few keys, versions, originators,
    value bytes and ttl versions, some value-less (TTL refreshes)."""
    T = P["port"].T
    out = []
    for _ in range(n):
        value = None if rng.random() < 0.15 else bytes(rng.integers(0, 4, size=2).tolist())
        val = T.Value(
            version=int(rng.integers(1, 4)),
            originator_id=f"n{int(rng.integers(0, 3))}",
            value=value,
            ttl_ms=int(rng.choice([-1, -1, 60_000, 0, -7])),
            ttl_version=int(rng.integers(0, 3)),
        )
        if with_hash and rng.random() < 0.5:
            val.hash = P["port"].kv.generate_hash(val.version, val.originator_id, val.value)
        out.append((f"k{int(rng.integers(0, keys))}", val))
    return out


def store_bytes(p, store: dict) -> bytes:
    """A key -> Value dict as canonical bytes (sorted keys)."""
    return p.ser.dumps(p.T.Publication(key_vals=dict(sorted(store.items()))))


@pytest.mark.parametrize("seed", range(4))
def test_generate_hash_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for _, val in random_values(rng, 200):
        args = (val.version, val.originator_id, val.value)
        assert P["port"].kv.generate_hash(*args) == P["ref"].kv.generate_hash(*args)
    big = bytes(rng.integers(0, 256, size=4096).tolist())
    assert P["port"].kv.generate_hash(7, "x", big) == P["ref"].kv.generate_hash(7, "x", big)


@pytest.mark.parametrize("seed", range(4))
def test_compare_values_equals_reference(seed):
    rng = np.random.default_rng(100 + seed)
    vals = [v for _, v in random_values(rng, 60, with_hash=True)]
    for a, b in itertools.product(vals, vals):
        assert P["port"].kv.compare_values(a, b) == P["ref"].kv.compare_values(
            to_ref(a), to_ref(b)
        )


@pytest.mark.parametrize("seed", range(6))
def test_merge_key_values_equals_reference(seed):
    """Batches of seeded updates merged in order: the same delta per
    batch and the same store bytes after each, with and without a key
    filter."""
    rng = np.random.default_rng(200 + seed)
    filters = None
    if seed % 2:
        filters = {
            name: P[name].kv.KvStoreFilters(["k1", "k2", "k3"], ["n2"]) for name in PACKAGES
        }
    stores = {name: {} for name in PACKAGES}
    for _ in range(30):
        batch = dict(random_values(rng, int(rng.integers(1, 6)), with_hash=seed >= 3))
        deltas = {}
        for name in PACKAGES:
            p = P[name]
            kv = {k: (v if name == "port" else to_ref(v)) for k, v in batch.items()}
            kv = {k: p.T.Value(**{f: getattr(v, f) for f in v.__slots__}) for k, v in kv.items()}
            deltas[name] = store_bytes(
                p, p.kv.merge_key_values(stores[name], kv, filters and filters[name])
            )
        assert deltas["port"] == deltas["ref"]
        assert store_bytes(P["port"], stores["port"]) == store_bytes(P["ref"], stores["ref"])


def test_merge_key_values_reference_cases():
    """tests/test_kvstore.py's TestMergeKeyValues on the port."""
    p = P["port"]

    def v(version=1, originator="node1", value=b"x", ttl_ms=-1, ttl_version=0):
        return p.T.Value(version, originator, value, ttl_ms, ttl_version)

    store = {}
    assert set(p.kv.merge_key_values(store, {"k": v()})) == {"k"}
    assert store["k"].hash is not None
    assert p.kv.merge_key_values(store, {"k": v(originator="node0")}) == {}
    assert set(p.kv.merge_key_values(store, {"k": v(value=b"y")})) == {"k"}
    assert set(p.kv.merge_key_values(store, {"k": v(value=b"y", ttl_ms=10_000, ttl_version=2)})) == {"k"}
    assert store["k"].ttl_version == 2 and store["k"].value == b"y"
    assert set(p.kv.merge_key_values(store, {"k": v(value=None, ttl_ms=20_000, ttl_version=3)})) == {"k"}
    assert store["k"].ttl_version == 3 and store["k"].value == b"y"
    assert p.kv.merge_key_values(store, {"z": v(ttl_ms=0)}) == {}
    assert p.kv.merge_key_values(store, {"z": v(value=None, ttl_version=1)}) == {}
    h = p.kv.generate_hash(1, "node1", b"x")
    assert p.kv.compare_values(v(value=None), v(value=b"a")) == -2
    assert p.kv.compare_values(p.T.Value(1, "node1", None, hash=h), p.T.Value(1, "node1", b"x", hash=h)) == 0


@pytest.mark.parametrize("seed", range(3))
def test_filters_equal_reference(seed):
    rng = np.random.default_rng(300 + seed)
    keys = ["adj:a", "adj:b", "prefix:[a]:[0]:[::/0]", "fibTime:a", "k1"]
    prefixes = [[], ["adj:"], ["prefix:", "k"]]
    origs = [[], ["a"], ["b", "c"]]
    for kp, og in itertools.product(prefixes, origs):
        f = {name: P[name].kv.KvStoreFilters(kp, og) for name in PACKAGES}
        for key in keys:
            val = P["port"].T.Value(1, str(rng.choice(["a", "b", "c", "d"])), b"x")
            for method in ("key_match", "key_match_all"):
                assert getattr(f["port"], method)(key, val) == getattr(f["ref"], method)(
                    key, to_ref(val)
                ), (kp, og, key, method)


def test_peer_fsm_table_equals_reference():
    port, ref = P["port"].kv, P["ref"].kv
    for state, event in itertools.product(range(3), (0, 2, 3)):
        got = want = None
        try:
            got = int(port.get_next_state(port.KvStorePeerState(state), port.KvStorePeerEvent(event)))
        except AssertionError:
            got = "invalid"
        try:
            want = int(ref.get_next_state(ref.KvStorePeerState(state), ref.KvStorePeerEvent(event)))
        except AssertionError:
            want = "invalid"
        assert got == want, (state, event)


@pytest.mark.parametrize("rate,burst", [(10.0, 2.0), (100.0, 5.0), (1.0, 1.0)])
def test_token_bucket_equals_reference(monkeypatch, rate, burst):
    """Both buckets on the same scripted clock grant the same calls."""
    clock = [1000.0]
    for name in PACKAGES:
        monkeypatch.setattr(P[name].kv.time, "monotonic", lambda: clock[0])
    buckets = {name: P[name].kv._TokenBucket(rate, burst) for name in PACKAGES}
    rng = np.random.default_rng(int(rate))
    granted = {name: [] for name in PACKAGES}
    for _ in range(300):
        clock[0] += float(rng.exponential(0.5 / rate))
        n = float(rng.choice([1.0, 1.0, 2.0]))
        for name in PACKAGES:
            granted[name].append(buckets[name].consume(n))
    assert granted["port"] == granted["ref"]
    assert any(granted["port"]) and not all(granted["port"])


# -- stores on InProcessTransport ---------------------------------------------


class Mesh:
    """Stores of one package on one InProcessTransport."""

    def __init__(self, p) -> None:
        self.p = p
        self.fabric = p.kv.InProcessTransport()
        self.stores = {}
        self.queues = []
        self.evbs = []
        self.clients = []

    def make(self, name, peer_queue=False, **kw):
        p = self.p
        updates, syncs = p.ReplicateQueue(), p.ReplicateQueue()
        peerq = p.ReplicateQueue() if peer_queue else None
        store = p.kv.KvStore(
            name, updates, syncs, peerq.get_reader() if peerq else None,
            transport=self.fabric.bind(name), **kw,
        )
        self.fabric.register(name, store)
        store.run()
        store.updates, store.syncs, store.peerq = updates, syncs, peerq
        self.queues += [q for q in (updates, syncs, peerq) if q is not None]
        self.stores[name] = store
        return store

    def client(self, store, node_id=None):
        evb = self.p.OpenrEventBase(name=f"client-{store.node_id}")
        evb.run()
        self.evbs.append(evb)
        client = self.p.client.KvStoreClientInternal(
            evb, node_id or store.node_id, store, store.updates.get_reader(),
            check_persist_interval_s=60,
        )
        self.clients.append(client)
        return client

    def value(self, version=1, originator="node", value=b"x", ttl_ms=-1, ttl_version=0):
        return self.p.T.Value(version, originator, value, ttl_ms, ttl_version)

    def spec(self, addr):
        return self.p.T.PeerSpec(peer_addr=addr)

    def peer(self, a, *others):
        self.stores[a].add_peers("0", {o: self.spec(o) for o in others})

    def initialized(self, pairs) -> bool:
        state = self.p.T.KvStorePeerState.INITIALIZED
        return all(self.stores[a].get_peer_state("0", b) == state for a, b in pairs)

    def dump(self, name, area="0") -> bytes:
        """A store's dump as canonical bytes, a finite TTL as 1."""
        pub = self.stores[name].dump_all(area)
        for val in pub.key_vals.values():
            if val.ttl_ms != -1:
                val.ttl_ms = 1
        return store_bytes(self.p, pub.key_vals)

    def dumps(self) -> dict:
        return {name: self.dump(name) for name in sorted(self.stores)}

    def flood_topo(self, name) -> bytes:
        return self.p.ser.dumps(self.stores[name].get_flood_topo("0"))

    def close(self):
        for client in self.clients:
            client.stop()
        for q in self.queues:
            q.close()
        for evb in self.evbs:
            evb.stop()
        for store in self.stores.values():
            store.stop()
        for module in [*self.evbs, *self.stores.values()]:
            module.wait_until_stopped(5)


def in_both(scenario) -> dict:
    """Run `scenario(mesh)` once per package; the returned records (bytes
    and plain values) must be equal.  Returns the port's record."""
    records = {}
    for name in PACKAGES:
        mesh = Mesh(P[name])
        try:
            records[name] = scenario(mesh)
        finally:
            mesh.close()
    assert records["port"] == records["ref"]
    return records["port"]


def test_full_sync_two_stores():
    def scenario(m):
        a, b = m.make("a"), m.make("b")
        reader = b.syncs.get_reader()
        a.set_key_vals("0", {"k1": m.value(originator="a", value=b"v1")})
        m.peer("b", "a")
        event = reader.get(timeout=10)
        assert m.initialized([("b", "a")])
        return {"event": m.p.ser.dumps(event), **m.dumps()}

    rec = in_both(scenario)
    assert rec["a"] == rec["b"]


def test_three_way_sync_sends_back_better_keys():
    def scenario(m):
        a, b = m.make("a"), m.make("b")
        a.set_key_vals("0", {"k1": m.value(originator="a", value=b"v1")})
        b.set_key_vals("0", {"k2": m.value(version=7, originator="b", value=b"v2")})
        reader = b.syncs.get_reader()
        m.peer("a", "b")
        m.peer("b", "a")
        reader.get(timeout=10)
        assert wait_for(lambda: a.get_key_vals("0", ["k2"]).key_vals.get("k2") is not None)
        assert wait_for(lambda: b.get_key_vals("0", ["k1"]).key_vals.get("k1") is not None)
        return m.dumps()

    rec = in_both(scenario)
    assert rec["a"] == rec["b"]


def test_flooding_line_and_local_publications():
    """a - b - c: a key set at a floods to c with the node-id trail; the
    local subscriber of a sees the publication with node_ids [a]."""

    def scenario(m):
        a, b, c = m.make("a"), m.make("b"), m.make("c")
        local = a.updates.get_reader()
        m.peer("a", "b")
        m.peer("b", "a", "c")
        m.peer("c", "b")
        assert wait_for(lambda: m.initialized([("a", "b"), ("b", "a"), ("b", "c"), ("c", "b")]))
        a.set_key_vals("0", {"flood-key": m.value(originator="a", value=b"fv")})
        assert wait_for(
            lambda: c.get_key_vals("0", ["flood-key"]).key_vals.get("flood-key") is not None
        )
        pub = local.get(timeout=10)
        while "flood-key" not in pub.key_vals:
            pub = local.get(timeout=10)
        return {"local": (pub.node_ids, sorted(pub.key_vals)), **m.dumps()}

    rec = in_both(scenario)
    assert rec["local"] == (["a"], ["flood-key"])
    assert rec["a"] == rec["b"] == rec["c"]


def test_ttl_expiry_and_decrement():
    """A 700 ms key set at a reaches b with its TTL decremented, then
    every store's countdown expires it; the expiry is published locally."""

    def scenario(m):
        a, b = m.make("a", ttl_decr_ms=100), m.make("b")
        local = b.updates.get_reader()
        m.peer("a", "b")
        m.peer("b", "a")
        assert wait_for(lambda: m.initialized([("a", "b"), ("b", "a")]))
        a.set_key_vals("0", {"mortal": m.value(originator="a", ttl_ms=1500), "immortal": m.value(originator="a")})
        assert wait_for(lambda: "mortal" in b.dump_all("0").key_vals)
        got = b.get_key_vals("0", ["mortal"]).key_vals["mortal"]
        assert 0 < got.ttl_ms < 1500
        before = m.dumps()
        assert wait_for(lambda: all("mortal" not in s.dump_all("0").key_vals for s in (a, b)))
        expired = []
        while not expired:
            expired = local.get(timeout=10).expired_keys
        return {"before": before, "expired": expired, "after": m.dumps()}

    rec = in_both(scenario)
    assert rec["expired"] == ["mortal"]
    assert rec["after"]["a"] == rec["after"]["b"]


def test_partition_backoff_and_recovery():
    def scenario(m):
        a, b = m.make("a"), m.make("b")
        reader = b.syncs.get_reader()
        m.fabric.set_partitioned("a", "b", True)
        a.set_key_vals("0", {"k": m.value(originator="a")})
        m.peer("b", "a")
        assert wait_for(
            lambda: b.get_counters().get("kvstore.thrift.num_full_sync_failure", 0) >= 1
        )
        assert b.get_peer_state("0", "a") == m.p.T.KvStorePeerState.IDLE
        m.fabric.set_partitioned("a", "b", False)
        reader.get(timeout=15)
        assert m.initialized([("b", "a")])
        return m.dumps()

    rec = in_both(scenario)
    assert rec["a"] == rec["b"]


def test_areas_are_isolated():
    def scenario(m):
        a = m.make("a", areas=("0", "1"))
        a.set_key_vals("1", {"k": m.value(originator="a")})
        return {"0": m.dump("a", "0"), "1": m.dump("a", "1")}

    rec = in_both(scenario)
    assert rec["0"] != rec["1"]


@pytest.mark.parametrize("seed", range(2))
def test_four_store_ring_with_partition(seed):
    """Four stores in a ring (a-b-c-d-a), seeded keys set at random
    stores while the a-b edge is partitioned and again after it heals:
    every store ends on the same bytes, in both packages."""
    rng = np.random.default_rng(400 + seed)
    plan = [
        (int(rng.integers(0, 4)), f"key{int(rng.integers(0, 12))}", int(rng.integers(1, 4)),
         bytes(rng.integers(0, 256, size=8).tolist()))
        for _ in range(24)
    ]
    names = ["a", "b", "c", "d"]

    def scenario(m):
        for n in names:
            m.make(n)
        m.fabric.set_partitioned("a", "b", True)
        for i, n in enumerate(names):
            m.peer(n, names[(i + 1) % 4], names[(i - 1) % 4])
        ring = [(n, names[(i + 1) % 4]) for i, n in enumerate(names)]
        ring += [(b, a) for a, b in ring]
        live = [(x, y) for x, y in ring if {x, y} != {"a", "b"}]
        assert wait_for(lambda: m.initialized(live))
        for k, (i, key, version, value) in enumerate(plan):
            if k == len(plan) // 2:
                m.fabric.set_partitioned("a", "b", False)
                assert wait_for(lambda: m.initialized(ring), timeout=20)
            m.stores[names[i]].set_key_vals(
                "0", {key: m.value(version=version, originator=names[i], value=value)}
            )
        assert wait_for(lambda: len(set(m.dumps().values())) == 1, timeout=20)
        return m.dumps()

    rec = in_both(scenario)
    assert len(set(rec.values())) == 1


def test_client_persist_key_ownership_and_ttl_refresh():
    """tests/test_kvstore.py's client cases: a persisted key overwritten
    by another originator is won back at a higher version; a finite-TTL
    persisted key stays alive through ttl_version refreshes; set_key
    bumps the version and feeds a subscription."""

    def scenario(m):
        a = m.make("a")
        client = m.client(a)
        client.persist_key("0", "my-key", b"mine")
        a.set_key_vals("0", {"my-key": m.value(version=5, originator="z", value=b"theirs")})
        assert wait_for(
            lambda: (kv := a.get_key_vals("0", ["my-key"]).key_vals.get("my-key")) is not None
            and kv.value == b"mine" and kv.version > 5
        )
        client.persist_key("0", "lively", b"val", ttl_ms=300)
        assert wait_for(
            lambda: (kv := a.get_key_vals("0", ["lively"]).key_vals.get("lively")) is not None
            and kv.ttl_version >= 3
        )
        seen = []
        client.subscribe_key("0", "s-key", lambda k, val: seen.append(val.version))
        client.set_key("0", "s-key", b"v1")
        val2 = client.set_key("0", "s-key", b"v2")
        assert wait_for(lambda: seen[-2:] == [1, 2])
        out = a.dump_all("0").key_vals
        return {
            "my-key": m.p.ser.dumps(out["my-key"]),
            "s-key": m.p.ser.dumps(out["s-key"]),
            "set_key": m.p.ser.dumps(val2),
            "lively": (out["lively"].version, out["lively"].value),
        }

    rec = in_both(scenario)
    assert rec["lively"] == (1, b"val")


# -- DUAL flood topology (tests/test_kvstore_dual.py) --------------------------


def spt_converged(m, names, root) -> bool:
    for n in names:
        infos = m.stores[n].get_flood_topo("0")
        spt = infos.infos.get(root)
        if infos.flood_root_id != root or spt is None or not spt.passive:
            return False
        if n != root and spt.parent is None:
            return False
    return True


def children_are(m, children: dict) -> bool:
    """Each store's registered SPT children per root are
    `children[root][store]` (child registrations land after the parents
    are chosen)."""
    return all(
        (info := m.stores[n].get_flood_topo("0").infos.get(root)) is not None
        and info.children == kids
        for root, by_store in children.items()
        for n, kids in by_store.items()
    )


def peer_pairs(m, peers: dict) -> None:
    """Add `peers[n]` to each store n with every peered pair partitioned,
    then heal: DUAL traffic then reaches a store only once it knows the
    sender as a peer, in both packages (the reference drops DUAL traffic
    from a not-yet-added peer as evidence the peer speaks DUAL, and then
    floods that peer outside the SPT; see
    `test_dual_traffic_before_peering_counts_as_seen`)."""
    pairs = {frozenset((n, o)) for n, others in peers.items() for o in others}
    for pair in pairs:
        m.fabric.set_partitioned(*pair, True)
    for n, others in peers.items():
        m.peer(n, *others)
    for pair in pairs:
        m.fabric.set_partitioned(*pair, False)


def full_mesh(m, names):
    peer_pairs(m, {n: [o for o in names if o != n] for n in names})


def all_pairs(names):
    return [(a, b) for a in names for b in names if a != b]


def test_triangle_spt_and_fanout():
    """A triangle rooted at a: b and c hang off a, a floods to both and
    they flood towards a only; a key set at c costs exactly 2 peer
    sends (c -> a -> b)."""

    def scenario(m):
        names = ["a", "b", "c"]
        for n in names:
            m.make(n, enable_flood_optimization=True, is_flood_root=n == "a")
        full_mesh(m, names)
        assert wait_for(lambda: m.initialized(all_pairs(names)))
        assert wait_for(lambda: spt_converged(m, names, "a"))
        s = m.stores
        assert wait_for(
            lambda: sorted(s["a"].get_flood_topo("0").flood_peers) == ["b", "c"]
            and s["b"].get_flood_topo("0").flood_peers == ["a"]
            and s["c"].get_flood_topo("0").flood_peers == ["a"]
            and s["a"].get_flood_topo("0").infos["a"].children == ["b", "c"]
        )

        def sends():
            return sum(x.get_counters().get("kvstore.thrift.num_flood_pub", 0) for x in s.values())

        before = sends()
        s["c"].set_key_vals("0", {"k": m.value(originator="c", value=b"fv")})
        assert wait_for(lambda: s["b"].get_key_vals("0", ["k"]).key_vals.get("k") is not None)
        assert wait_for(lambda: sends() - before == 2)
        return {"topo": [m.flood_topo(n) for n in names], "sends": sends() - before, **m.dumps()}

    rec = in_both(scenario)
    assert rec["sends"] == 2


def test_line_spt_and_root_failover():
    """a - b - c with roots a and b: c's parent is b at cost 2; a dies
    (partitioned, peers deleted) and b, c fall back to root b and keep
    flooding."""

    def scenario(m):
        for n in "abc":
            m.make(n, enable_flood_optimization=True, is_flood_root=n in "ab")
        peer_pairs(m, {"a": ["b"], "b": ["a", "c"], "c": ["b"]})
        assert wait_for(lambda: m.initialized([("a", "b"), ("b", "a"), ("b", "c"), ("c", "b")]))
        assert wait_for(lambda: spt_converged(m, "abc", "a"))
        assert wait_for(lambda: children_are(m, {
            "a": {"a": ["b"], "b": ["c"], "c": []},
            "b": {"a": [], "b": ["a", "c"], "c": []},
        }))
        line = [m.flood_topo(n) for n in "abc"]
        m.fabric.set_partitioned("a", "b", True)
        m.stores["b"].del_peers("0", ["a"])
        assert wait_for(lambda: spt_converged(m, "bc", "b"))
        assert wait_for(lambda: children_are(m, {
            "a": {"b": [], "c": []},
            "b": {"b": ["c"], "c": []},
        }))
        m.stores["b"].set_key_vals("0", {"after": m.value(originator="b")})
        assert wait_for(lambda: "after" in m.stores["c"].dump_all("0").key_vals)
        return {"line": line, "failover": [m.flood_topo(n) for n in "bc"],
                "b": m.dump("b"), "c": m.dump("c")}

    rec = in_both(scenario)
    assert rec["b"] == rec["c"]


def test_no_root_full_mesh_and_disabled_store():
    """No flood root: no SPT, full-mesh flooding; a store with the
    optimization off drops DUAL messages and still gets every flood from
    an enabled mesh."""

    def scenario(m):
        a = m.make("a", enable_flood_optimization=True, is_flood_root=False)
        b = m.make("b", enable_flood_optimization=True, is_flood_root=False)
        full_mesh(m, "ab")
        assert wait_for(lambda: m.initialized(all_pairs("ab")))
        assert a.get_flood_topo("0").flood_root_id is None
        a.set_key_vals("0", {"k": m.value(originator="a")})
        assert wait_for(lambda: "k" in b.dump_all("0").key_vals)
        off = m.make("off")
        T = m.p.T
        off.process_dual_messages("0", T.DualMessages("x", [T.DualMessage("x", 0)]))
        counters = off.get_counters()
        return {
            "dropped": (counters.get("kvstore.dual.num_pkt_dropped"),
                        counters.get("kvstore.dual.num_pkt_recv", 0)),
            "off_topo": m.flood_topo("off"),
            "a": m.dump("a"), "b": m.dump("b"),
        }

    rec = in_both(scenario)
    assert rec["dropped"] == (1, 0)


def test_mixed_config_peer_reassert_and_anti_entropy():
    """c (optimization off) in an enabled a-b mesh keeps getting floods;
    a lost child registration at a is restored by b's re-assert; an
    anti-entropy sync fires no new sync event; a full-sync delta is not
    echoed back to its sender."""

    def scenario(m):
        a = m.make("a", enable_flood_optimization=True, is_flood_root=True)
        b = m.make("b", enable_flood_optimization=True, is_flood_root=False)
        a.set_key_vals("0", {f"k{i}": m.value(originator="a") for i in range(5)})
        m.make("c")
        full_mesh(m, "abc")
        assert wait_for(lambda: m.initialized(all_pairs("abc")))
        assert wait_for(lambda: spt_converged(m, "ab", "a"))
        assert wait_for(lambda: a.get_flood_topo("0").infos["a"].children == ["b"])
        a.set_key_vals("0", {"mixed": m.value(originator="a")})
        assert wait_for(lambda: "mixed" in m.stores["c"].dump_all("0").key_vals)
        a._call(lambda: a._db("0").dual.get_dual("a").remove_child("b"))
        b._call(lambda: b._db("0").reassert_spt_children())
        assert wait_for(lambda: a.get_flood_topo("0").infos["a"].children == ["b"])
        reader = b.syncs.get_reader()
        b._call(lambda: b._db("0").anti_entropy_sync())
        assert wait_for(
            lambda: b.get_counters().get("kvstore.num_anti_entropy_sync_success", 0) >= 1
        )
        assert wait_for(lambda: m.initialized([("b", "a")]))
        assert wait_for(lambda: len(set(m.dumps().values())) == 1)
        return {"sync_events": reader.size(), "topo": [m.flood_topo(n) for n in "ab"], **m.dumps()}

    rec = in_both(scenario)
    assert rec["sync_events"] == 0


def test_dual_backlog_bounded_to_unreachable_peer():
    def scenario(m):
        a = m.make("a", enable_flood_optimization=True, is_flood_root=True)
        m.peer("a", "ghost")
        cap = m.p.kv.DUAL_SEND_BACKLOG_MAX

        def storm():
            db = a._db("0")
            peer = db.peers["ghost"]
            for _ in range(cap * 3):
                db._dual_to_peer(peer, object())
            for i in range(50):
                db._send_topo_set(
                    peer, m.p.T.FloodTopoSetParams(root_id="a", src_id="a", set_child=bool(i % 2))
                )
            return len(peer.outbox), len(peer.pending_topo_set)

        outbox, topo = a._call(storm)
        return {"bounded": outbox <= cap and topo <= 2,
                "dropped": a.get_counters().get("kvstore.dual.num_pkt_backlog_dropped", 0) >= cap}

    assert in_both(scenario) == {"bounded": True, "dropped": True}


def test_dual_traffic_before_peering_counts_as_seen():
    """F3: c processes b's DUAL update before c adds b as a peer, and the
    converged b never sends c another.  The port's c counts that update
    when it adds b (`pkt_counters`) and floods only its SPT parent a;
    the reference's c keeps b as a peer that never spoke DUAL and floods
    it too, outside the SPT, for good."""
    flood_peers = {}
    for name in PACKAGES:
        m = Mesh(P[name])
        try:
            a, b, c = (
                m.make(n, enable_flood_optimization=True, is_flood_root=n == "a")
                for n in "abc"
            )
            peer_pairs(m, {"a": ["b", "c"], "b": ["a"], "c": ["a"]})
            assert wait_for(lambda: spt_converged(m, "abc", "a"))
            assert wait_for(lambda: children_are(m, {"a": {"a": ["b", "c"], "b": [], "c": []}}))
            m.peer("b", "c")
            assert wait_for(
                lambda: c._call(lambda: c._db("0").dual.pkt_counters.get("b", {}).get("pkt_recv", 0))
            )
            m.peer("c", "b")
            assert wait_for(lambda: m.initialized([("b", "c"), ("c", "b")]))
            flood_peers[name] = c.get_flood_topo("0").flood_peers
        finally:
            m.close()
    assert flood_peers == {"port": ["a"], "ref": ["a", "b"]}


@pytest.mark.parametrize("src", PACKAGES)
def test_contents_cross_between_packages_as_serialized_values(src):
    """One package's store contents, as the bytes of a Publication of its
    dump, read by the other package's `loads` and set into its store:
    both stores then dump the same bytes, hashes included."""
    dst = "ref" if src == "port" else "port"
    rng = np.random.default_rng(500)
    meshes = {name: Mesh(P[name]) for name in PACKAGES}
    try:
        a = meshes[src].make("a")
        b = meshes[dst].make("b")
        T = P[src].T
        a.set_key_vals("0", {
            f"adj:n{i}": T.Value(
                int(rng.integers(1, 5)), f"n{i}", bytes(rng.integers(0, 256, size=16).tolist())
            )
            for i in range(64)
        })
        wire = P[src].ser.dumps(a.dump_all("0"))
        b.set_key_vals("0", P[dst].ser.loads(wire).key_vals)
        assert meshes[dst].dump("b") == meshes[src].dump("a")
        assert P[dst].ser.dumps(b.dump_all("0")) == wire
    finally:
        for m in meshes.values():
            m.close()
