"""PrefixState: prefix -> {(node, area) -> PrefixEntry}.

Port of `openr_tpu.decision.prefix_state` (reference:
openr/decision/PrefixState.{h,cpp}:22-71).
"""

from __future__ import annotations

from typing import Optional

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

    def delete_prefix(self, node: str, area: str, prefix: str) -> set[str]:
        """The changed prefix set; empty if (node, area) was not
        advertising it (reference: PrefixState::deletePrefix)."""
        prefix = normalize_prefix(prefix)
        entries = self._prefixes.get(prefix)
        if entries is None or entries.pop((node, area), None) is None:
            return set()
        if not entries:
            del self._prefixes[prefix]
        return {prefix}

    def delete_all_from_node(self, node: str, area: str) -> set[str]:
        """Withdraw everything a (node, area) advertised."""
        changed: set[str] = set()
        for prefix in list(self._prefixes):
            changed |= self.delete_prefix(node, area, prefix)
        return changed

    def get_received_routes_filtered(
        self,
        prefixes: Optional[list[str]] = None,
        node_name: Optional[str] = None,
        area_name: Optional[str] = None,
    ) -> list[tuple[str, list[tuple[NodeAndArea, PrefixEntry]]]]:
        """Reference: getReceivedRoutesFiltered (PrefixState.cpp:59-88)."""
        out: list[tuple[str, list[tuple[NodeAndArea, PrefixEntry]]]] = []
        targets = (
            [normalize_prefix(p) for p in prefixes]
            if prefixes is not None
            else sorted(self._prefixes)
        )
        for prefix in targets:
            entries = self._prefixes.get(prefix)
            if not entries:
                continue
            rows = [
                (na, e)
                for na, e in sorted(entries.items())
                if (node_name is None or na[0] == node_name)
                and (area_name is None or na[1] == area_name)
            ]
            if rows:
                out.append((prefix, rows))
        return out

    @staticmethod
    def has_conflicting_forwarding_info(entries: PrefixEntries) -> bool:
        """True if the entries disagree on forwarding type or algorithm
        (reference: hasConflictingForwardingInfo)."""
        infos = {
            (e.forwarding_type, e.forwarding_algorithm) for e in entries.values()
        }
        return len(infos) > 1
