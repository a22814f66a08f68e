"""packing.card_build_pct's reader on made-up program spans: 100 where
every superframe prepared was built on the card, 0 where none was, the
share in between, and no value where nothing was prepared.  A card build
counts with its group's stream.prepare: not where that prepare starts
before the window, and where it starts in the window and the build
after it."""

from types import SimpleNamespace

import pytest

from harness import spec as specmod
from pluto_gps_sim_tpu_torch.runtime import trace


def _span(name: str, n: float, t0: float, group: int) -> trace.Span:
    return trace.Span(name, t0, t0 + 0.001, "iqstream-planner",
                      "stream.prepare" if name != "stream.prepare" else None,
                      f"stream 1 / group {group}", n, None, 0)


@pytest.mark.parametrize("built,prepared,want", [
    ([8.0, 8.0], [8.0, 8.0], 100.0),
    ([], [8.0, 8.0], 0.0),
    ([1.0, 2.0], [1.0, 2.0, 4.0, 1.0], 37.5),
    ([], [], None)])
def test_card_build_pct_reads_made_up_spans(monkeypatch, built, prepared,
                                            want):
    made = [_span("stream.prepare", n, 1.0 + i, i)
            for i, n in enumerate(prepared)]
    made += [_span("packing.card_build", n, 1.0005 + i, i)
             for i, n in enumerate(built)]
    made.append(_span("stream.plan", 8.0, 1.0, 0))
    monkeypatch.setattr(trace, "spans", lambda t0=float("-inf"),
                        t1=float("inf"): [s for s in made if t0 <= s.t0 <= t1])
    read = specmod.metric_reader("packing.card_build_pct")
    assert read(SimpleNamespace(t0=0.0, t1=10.0)) == want


def test_card_build_pct_counts_builds_with_their_prepare(monkeypatch):
    """Group 0's prepare starts before the window and its build inside;
    group 2's prepare starts at the window's end and its build after."""
    made = [_span("stream.prepare", 8.0, 0.9996, 0),
            _span("packing.card_build", 8.0, 1.0001, 0),
            _span("stream.prepare", 8.0, 1.5, 1),
            _span("packing.card_build", 8.0, 1.5005, 1),
            _span("stream.prepare", 4.0, 1.9999, 2),
            _span("packing.card_build", 4.0, 2.0003, 2)]
    monkeypatch.setattr(trace, "spans", lambda t0=float("-inf"),
                        t1=float("inf"): [s for s in made if t0 <= s.t0 <= t1])
    read = specmod.metric_reader("packing.card_build_pct")
    assert read(SimpleNamespace(t0=1.0, t1=2.0)) == 100.0
