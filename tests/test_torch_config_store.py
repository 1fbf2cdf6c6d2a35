"""The port's PersistentStore (`openr_tpu_torch.config_store`) against
`openr_tpu`'s (oracle `tests/test_config_store.py`).

The same seeded operations give byte-equal store files after every
append and every full rewrite, each package reads the file the other
wrote to the same contents, and the TLV codec encodes and decodes the
same records to the same bytes, torn tails included.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("port", "ref")


def pkg(name: str) -> SimpleNamespace:
    if name == "port":
        from openr_tpu_torch.config_store import persistent_store as ps
    else:
        from openr_tpu.config_store import persistent_store as ps
    return SimpleNamespace(name=name, ps=ps)


P = {name: pkg(name) for name in PACKAGES}


def random_objects(p, rng, n: int) -> list:
    out = []
    for _ in range(n):
        key = f"key-{int(rng.integers(0, 6))}"
        if rng.random() < 0.3:
            out.append(p.ps.PersistentObject(p.ps.ActionType.DEL, key))
        else:
            data = bytes(rng.integers(0, 256, size=int(rng.integers(0, 40))).tolist())
            out.append(p.ps.PersistentObject(p.ps.ActionType.ADD, key, data))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_codec_bytes_equal(seed):
    blobs, decoded = {}, {}
    for name, p in P.items():
        objs = random_objects(p, np.random.default_rng(seed), 30)
        blobs[name] = b"".join(p.ps.encode_persistent_object(o) for o in objs)
        decoded[name] = [
            (int(o.type), o.key, o.data) for o in p.ps.decode_persistent_objects(blobs[name])
        ]
    assert blobs["port"] == blobs["ref"]
    assert decoded["port"] == decoded["ref"]
    assert P["port"].ps.TLV_MARKER == P["ref"].ps.TLV_MARKER


@pytest.mark.parametrize("cut", [1, 3, 5, 9])
def test_torn_tail_decodes_equally(cut):
    got = {}
    for name, p in P.items():
        objs = random_objects(p, np.random.default_rng(cut), 8)
        blob = b"".join(p.ps.encode_persistent_object(o) for o in objs)
        got[name] = [
            (int(o.type), o.key, o.data)
            for o in p.ps.decode_persistent_objects(blob[:-cut], tolerate_truncation=True)
        ]
        with pytest.raises(ValueError):
            p.ps.decode_persistent_objects(blob[:-cut])
    assert got["port"] == got["ref"]


def run_ops(p, path, seed: int, n: int = 60) -> list:
    """Seeded store / erase / rewrite operations on a fresh store at
    `path`; the file's bytes after each, and the final keys."""
    rng = np.random.default_rng(seed)
    store = p.ps.PersistentStore(str(path))
    files = []
    for _ in range(n):
        op = rng.random()
        key = f"k{int(rng.integers(0, 8))}"
        if op < 0.55:
            store.store(key, bytes(rng.integers(0, 256, size=int(rng.integers(0, 24))).tolist()))
        elif op < 0.85:
            store.erase(key)
        else:
            assert store.save_database_to_disk()
        files.append(path.read_bytes() if path.exists() else b"")
    keys = store.keys()
    values = [store.load(k) for k in keys]
    store.close()
    files.append(path.read_bytes())
    return files, keys, values, store.num_writes_to_disk


@pytest.mark.parametrize("seed", range(4))
def test_same_operations_write_the_same_file(seed, tmp_path):
    runs = {name: run_ops(p, tmp_path / f"{name}.bin", seed) for name, p in P.items()}
    assert runs["port"] == runs["ref"]


@pytest.mark.parametrize("writer", PACKAGES)
def test_each_reads_the_others_file(writer, tmp_path):
    path = tmp_path / "store.bin"
    rng = np.random.default_rng(5)
    store = P[writer].ps.PersistentStore(str(path))
    want = {}
    for i in range(40):
        key = f"k{int(rng.integers(0, 10))}"
        if rng.random() < 0.25 and key in want:
            store.erase(key)
            del want[key]
        else:
            want[key] = f"v{i}".encode()
            store.store(key, want[key])
    # an appended log (no rewrite yet), then the compacted file
    for phase in ("log", "rewritten"):
        if phase == "rewritten":
            store.close()
        for name, p in P.items():
            reader = p.ps.PersistentStore(str(path), dryrun=True)
            assert {k: reader.load(k) for k in reader.keys()} == want, (phase, name)
            reader.close()


def test_restart_and_torn_append_recover_equally(tmp_path):
    got = {}
    for name, p in P.items():
        path = tmp_path / f"{name}.bin"
        store = p.ps.PersistentStore(str(path))
        store.store("drain", b"true")
        store.store("gone", b"x")
        store.erase("gone")
        store.store("prefix-index", b"42")
        store.close()
        with open(path, "ab") as f:
            f.write(b"\x01\xff\xff")  # a torn partial record
        again = p.ps.PersistentStore(str(path))
        got[name] = (again.keys(), again.load("drain"), again.load("prefix-index"))
        again.close()
    assert got["port"] == got["ref"] == (["drain", "prefix-index"], b"true", b"42")


def test_dryrun_writes_nothing_in_both(tmp_path):
    for name, p in P.items():
        path = tmp_path / f"{name}.bin"
        store = p.ps.PersistentStore(str(path), dryrun=True)
        store.store("k", b"v")
        assert store.load("k") == b"v"
        store.close()
        assert not os.path.exists(path)


def test_bad_marker_is_ignored_equally(tmp_path):
    for name, p in P.items():
        path = tmp_path / f"{name}.bin"
        path.write_bytes(b"NotTheMarker" + b"\x01\x00\x00\x00\x00")
        store = p.ps.PersistentStore(str(path), dryrun=True)
        assert store.keys() == []
        store.close()
