"""The metric arithmetic on synthetic timelines."""

import pytest

import timeline


def test_time_per_state_counts_the_state_in_flight():
    # a 10 s window: states end at 3, 6, 9 and the one started at 9 ends at 12
    assert timeline.time_per_state(0.0, [3.0, 6.0, 9.0, 12.0]) == pytest.approx(3.0)
    with pytest.raises(ValueError):
        timeline.time_per_state(0.0, [])


def test_idle_is_one_minus_the_union_of_device_intervals():
    busy = [(1, 3), (2, 4), (6, 7), (6.5, 6.8), (9, 12)]
    assert timeline.merge(busy) == [(1, 4), (6, 7), (9, 12)]
    assert timeline.union_length(timeline.clip(busy, 0, 10)) == pytest.approx(5.0)
    assert timeline.gaps(busy, 0, 10) == [(0, 1), (4, 6), (7, 9)]
    # a sum of interval lengths would count the overlaps twice
    assert sum(e - s for s, e in timeline.clip(busy, 0, 10)) > 5.0


def test_self_times_of_nested_spans():
    spans = [("state", 0, 10), ("a", 1, 3), ("b", 2, 2.5), ("c", 5, 8), ("state", 11, 12)]
    self_t = timeline.self_times(spans)
    assert self_t == pytest.approx({"state": 6.0, "a": 1.5, "b": 0.5, "c": 3.0})


def test_idle_gaps_labelled_by_the_innermost_open_span():
    spans = [("state", 0, 10), ("a", 1, 3), ("b", 2, 2.5), ("c", 5, 8), ("state", 11, 12)]
    idle = timeline.label_gaps([(0.5, 2.2), (2.4, 6), (9, 11.5)], spans, "out")
    assert idle == pytest.approx({"state": 4.0, "a": 1.5, "b": 0.3, "c": 1.0, "out": 1.0})


def test_spread_is_the_quartile_distance_over_the_median():
    assert timeline.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert timeline.spread([0.9, 1.0, 1.0, 1.1]) == pytest.approx(0.15, rel=1e-6)


def test_the_spread_of_a_set_is_its_quartile_distance_over_the_median():
    import sets

    assert sets.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == (4.5 - 1.5) / 3.0
