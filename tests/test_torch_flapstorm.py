"""The port's flap storm (`openr_tpu_torch.chaos.FlapStormScenario`)
against `openr_tpu.chaos.FlapStormScenario`, on the CPU.

Oracle: tests/test_flapstorm.py.  The same seed replays the same event
sequence through both packages' `FleetViewCache(delta=True)`: equal
scenario logs, chunk modes, delta-rung counts and coalesced events, and
both post-storm products bit-exact against a cold rebuild.  The parity
run is a 200-event storm (the reference's jit compiles dominate its
cost); the port alone replays the reference's full 1000-event storm.
"""

from __future__ import annotations

import pytest

from openr_tpu.chaos import ChaosEventLog as JLog
from openr_tpu.chaos import FlapStormScenario as JStorm
from openr_tpu_torch.chaos import ChaosEventLog, FlapStormScenario

pytestmark = pytest.mark.chaos

FIELDS = ("events", "chunks", "delta_updates", "delta_noops", "delta_fallbacks",
          "delta_dispatches", "full_restages", "bit_exact", "chunk_modes", "counters")


@pytest.fixture(scope="module")
def storm():
    log = ChaosEventLog()
    return FlapStormScenario(seed=7, log_=log, device="cpu").run(), log


def test_storm_is_the_references():
    log, jlog = ChaosEventLog(), JLog()
    port = FlapStormScenario(seed=7, events=200, log_=log, device="cpu").run()
    ref = JStorm(seed=7, events=200, log_=jlog).run()
    assert {k: getattr(port, k) for k in FIELDS} == {k: getattr(ref, k) for k in FIELDS}
    assert log.streams() == jlog.streams()
    assert port.bit_exact and port.chunk_modes == ["delta"] * 4


def test_every_chunk_lands_through_the_delta_path(storm):
    result, _ = storm
    assert result.chunk_modes == ["delta"] * result.chunks
    assert result.delta_updates == result.chunks
    assert result.delta_fallbacks == 0


def test_post_storm_product_is_bit_exact_and_one_restage(storm):
    result, _ = storm
    assert result.bit_exact
    assert result.full_restages == 1
    assert 2 * result.chunks <= result.delta_dispatches <= 3 * result.chunks


def test_storm_coalesces_events_into_chunk_dispatches(storm):
    result, _ = storm
    assert result.events == 1000
    assert result.counters["decision.delta.events_coalesced"] > 0
    assert result.delta_updates + result.delta_noops == result.chunks


def test_same_seed_replays_and_another_diverges(storm):
    _, log = storm
    again, other = ChaosEventLog(), ChaosEventLog()
    FlapStormScenario(seed=7, log_=again, device="cpu").run()
    FlapStormScenario(seed=8, log_=other, device="cpu").run()
    assert log.matches(again)
    assert not log.matches(other)
