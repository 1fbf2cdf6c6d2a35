"""BGP MetricVector comparison.

Port of `openr_tpu.decision.metric_vector` (reference: MetricVectorUtils,
openr/common/Util.h:455-480 / Util.cpp:945-1093), host Python.

Two vectors are walked in decreasing entity priority.  Entities present in
both vectors compare their metric lists lexicographically; an entity
present in only one vector resolves through its CompareType ("loner"
handling).  Entities flagged is_best_path_tie_breaker produce TIE_WINNER/
TIE_LOOSER instead of WINNER/LOOSER: a tie-breaker result orders the best
path but keeps the looser in the ECMP set (runBestPathSelectionBgp,
openr/decision/Decision.cpp:865-903).
"""

from __future__ import annotations

import enum

from ..types import CompareType, MetricEntity, MetricVector


class CompareResult(enum.Enum):
    WINNER = "WINNER"
    TIE_WINNER = "TIE_WINNER"
    TIE = "TIE"
    TIE_LOOSER = "TIE_LOOSER"
    LOOSER = "LOOSER"
    ERROR = "ERROR"


_NEGATE = {
    CompareResult.WINNER: CompareResult.LOOSER,
    CompareResult.TIE_WINNER: CompareResult.TIE_LOOSER,
    CompareResult.TIE: CompareResult.TIE,
    CompareResult.TIE_LOOSER: CompareResult.TIE_WINNER,
    CompareResult.LOOSER: CompareResult.WINNER,
    CompareResult.ERROR: CompareResult.ERROR,
}


def negate(result: CompareResult) -> CompareResult:
    """Reference: operator! (Util.cpp:946)."""
    return _NEGATE[result]


def is_decisive(result: CompareResult) -> bool:
    """WINNER/LOOSER/ERROR terminate the walk; TIE_* keep scanning for a
    decisive lower-priority entity (Util.cpp:971)."""
    return result in (
        CompareResult.WINNER,
        CompareResult.LOOSER,
        CompareResult.ERROR,
    )


def _sorted_metrics(mv: MetricVector) -> list[MetricEntity]:
    """Decreasing priority (reference sorts in place, Util.cpp:990;
    stable like std::sort is not required to be, but determinism is)."""
    return sorted(mv.metrics, key=lambda e: -e.priority)


def compare_metrics(
    l: tuple[int, ...], r: tuple[int, ...], tie_breaker: bool
) -> CompareResult:
    """Lexicographic metric-list compare (Util.cpp:1005-1023): longer-
    vs-shorter lists are an ERROR, larger element wins."""
    if len(l) != len(r):
        return CompareResult.ERROR
    for lv, rv in zip(l, r):
        if lv > rv:
            return (
                CompareResult.TIE_WINNER if tie_breaker else CompareResult.WINNER
            )
        if lv < rv:
            return (
                CompareResult.TIE_LOOSER if tie_breaker else CompareResult.LOOSER
            )
    return CompareResult.TIE


def result_for_loner(entity: MetricEntity) -> CompareResult:
    """Resolution for an entity present in only one vector
    (Util.cpp:1026-1038)."""
    if entity.op == CompareType.WIN_IF_PRESENT:
        return (
            CompareResult.TIE_WINNER
            if entity.is_best_path_tie_breaker
            else CompareResult.WINNER
        )
    if entity.op == CompareType.WIN_IF_NOT_PRESENT:
        return (
            CompareResult.TIE_LOOSER
            if entity.is_best_path_tie_breaker
            else CompareResult.LOOSER
        )
    return CompareResult.TIE  # IGNORE_IF_NOT_PRESENT


def _maybe_update(target: CompareResult, update: CompareResult) -> CompareResult:
    """A decisive update always sticks; a TIE_* update only replaces a
    plain TIE (the first tie-breaker seen wins the tie, Util.cpp:1041)."""
    if is_decisive(update) or target == CompareResult.TIE:
        return update
    return target


def compare_metric_vectors(
    l: MetricVector, r: MetricVector
) -> CompareResult:
    """Reference: compareMetricVectors (Util.cpp:1047-1093)."""
    if l.version != r.version:
        return CompareResult.ERROR
    lm = _sorted_metrics(l)
    rm = _sorted_metrics(r)
    result = CompareResult.TIE
    li = ri = 0
    while not is_decisive(result) and li < len(lm) and ri < len(rm):
        le, re = lm[li], rm[ri]
        if le.type == re.type:
            if le.is_best_path_tie_breaker != re.is_best_path_tie_breaker:
                result = _maybe_update(result, CompareResult.ERROR)
            else:
                result = _maybe_update(
                    result,
                    compare_metrics(
                        tuple(le.metric),
                        tuple(re.metric),
                        le.is_best_path_tie_breaker,
                    ),
                )
            li += 1
            ri += 1
        elif le.priority > re.priority:
            result = _maybe_update(result, result_for_loner(le))
            li += 1
        elif le.priority < re.priority:
            result = _maybe_update(result, negate(result_for_loner(re)))
            ri += 1
        else:
            # same priority, different type: vectors are not comparable
            result = _maybe_update(result, CompareResult.ERROR)
            li += 1
            ri += 1
    while not is_decisive(result) and li < len(lm):
        result = _maybe_update(result, result_for_loner(lm[li]))
        li += 1
    while not is_decisive(result) and ri < len(rm):
        result = _maybe_update(result, negate(result_for_loner(rm[ri])))
        ri += 1
    return result
