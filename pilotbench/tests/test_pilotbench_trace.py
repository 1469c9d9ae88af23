"""The reduction of a device trace: busy time as a union, idle gaps labelled
by the program's spans, kernel names shortened."""

import pytest

from pilotbench.trace import DeviceOp, base_name, flatten_spans, label_gaps, short_name, top_ops, union_busy


def op(start, dur, name="k"):
    return DeviceOp(name, "kernel", start, dur)


def test_union_busy_overlaps_and_clips():
    ops = [op(1.0, 1.0), op(1.5, 1.0), op(4.0, 1.0), op(9.5, 2.0)]
    busy, gaps = union_busy(ops, 0.0, 10.0)
    assert busy == pytest.approx(1.5 + 1.0 + 0.5)
    assert gaps == [(0.0, 1.0), (2.5, 4.0), (5.0, 9.5)]


def test_label_gaps_by_deepest_span():
    spans = [("query", 0.0, 10.0, 0), ("query/pilot", 1.0, 3.0, 1),
             ("query/pilot/scan", 2.0, 2.5, 2)]
    got = dict(label_gaps([(1.1, 1.3), (2.1, 2.2), (5.0, 6.0), (20.0, 21.0)], spans))
    assert got == pytest.approx({"query/pilot": 0.2, "query/pilot/scan": 0.1,
                                 "query": 1.0, "harness": 1.0})
    # one gap across several spans is split between them
    got = dict(label_gaps([(1.5, 4.0), (9.0, 11.0)], spans))
    assert got == pytest.approx({"query/pilot": 1.0, "query/pilot/scan": 0.5,
                                 "query": 2.0, "harness": 1.0})
    # where queries overlap, the latest started span is the one at work
    drain = [("query", 0.0, 10.0, 0), ("query/schedule", 0.0, 5.0, 1),
             ("query", 0.0, 10.0, 0), ("query/rate_solve", 1.0, 3.0, 1)]
    assert dict(label_gaps([(2.0, 4.0)], drain)) == pytest.approx(
        {"query/rate_solve": 1.0, "query/schedule": 1.0})


def test_flatten_spans():
    tree = {"root": {"name": "query", "t_start_s": 0.0, "duration_s": 2.0, "children": [
        {"name": "pilot", "t_start_s": 0.5, "duration_s": 1.0, "children": []}]}}
    assert flatten_spans(tree, 100.0) == [("query", 100.0, 102.0, 0),
                                          ("query/pilot", 100.5, 101.5, 1)]
    assert flatten_spans(None, 0.0) == []


def test_names():
    assert short_name("void at::native::(anonymous namespace)::reduce<float>(int, float*)") == \
        "at::native::(anonymous namespace)::reduce"
    assert short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert short_name("void filtered_agg_kernel<4>(float const*, int)") == "filtered_agg_kernel"
    assert short_name("segment_few_warp_kernel(float*)") == "segment_few_warp_kernel"
    assert base_name("void repro_torch::segment_few_lane_kernel<3>(float*)") == \
        "segment_few_lane_kernel"
    assert top_ops([op(0, 1, "void a<1>()"), op(0, 2, "b()"), op(0, 2, "void a<2>()")]) == \
        [["a", 3], ["b", 2]]
