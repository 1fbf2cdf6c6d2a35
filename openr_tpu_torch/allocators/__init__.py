"""Distributed allocators over KvStore consensus (port of
`openr_tpu.allocators`)."""

from .range_allocator import RangeAllocator
from .prefix_allocator import PrefixAllocator

__all__ = ["PrefixAllocator", "RangeAllocator"]
