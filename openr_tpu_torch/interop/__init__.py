"""Interop surfaces toward stock openr peers (thrift binary codec + shim);
port of `openr_tpu.interop`."""

from .thrift_binary import (  # noqa: F401
    ADJACENCY,
    ADJACENCY_DATABASE,
    BINARY_ADDRESS,
    KEY_DUMP_PARAMS,
    KEY_GET_PARAMS,
    KEY_SET_PARAMS,
    PEER_SPEC,
    PERF_EVENT,
    PERF_EVENTS,
    PUBLICATION,
    VALUE,
    decode_message,
    decode_struct,
    encode_message,
    encode_struct,
    frame,
)
from .shim import ThriftBinaryShim  # noqa: F401
