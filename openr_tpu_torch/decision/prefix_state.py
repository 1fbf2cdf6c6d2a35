"""PrefixState: prefix -> {(node, area) -> PrefixEntry}.

Port of `openr_tpu.decision.prefix_state` (reference:
openr/decision/PrefixState.{h,cpp}:22-71).
"""

from __future__ import annotations

from ..types import PrefixEntry, normalize_prefix

NodeAndArea = tuple[str, str]
PrefixEntries = dict[NodeAndArea, PrefixEntry]


class PrefixState:
    def __init__(self) -> None:
        self._prefixes: dict[str, PrefixEntries] = {}

    @property
    def prefixes(self) -> dict[str, PrefixEntries]:
        return self._prefixes

    def update_prefix(
        self, node: str, area: str, entry: PrefixEntry
    ) -> set[str]:
        """Returns the set of changed prefixes (reference:
        PrefixState::updatePrefix, PrefixState.cpp:16-38)."""
        prefix = normalize_prefix(entry.prefix)
        entries = self._prefixes.setdefault(prefix, {})
        key = (node, area)
        if key in entries and entries[key] == entry:
            return set()
        entries[key] = entry
        return {prefix}
