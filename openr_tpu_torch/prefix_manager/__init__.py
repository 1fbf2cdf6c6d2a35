"""PrefixManager: route origination and cross-area redistribution
(port of `openr_tpu.prefix_manager`)."""

from .prefix_manager import OriginatedPrefixConfig, PrefixManager

__all__ = ["OriginatedPrefixConfig", "PrefixManager"]
