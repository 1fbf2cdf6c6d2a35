"""PersistentStore: disk-backed KV surviving restarts (port of
`openr_tpu.config_store`)."""

from .persistent_store import PersistentObject, PersistentStore

__all__ = ["PersistentObject", "PersistentStore"]
