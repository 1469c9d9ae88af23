"""Progressive answer streaming (``repro_torch.stream``) against the
reference and against itself, on the CPU.

The reference's ``tests/test_stream.py`` cases run here by name against the
port, on the reference tests' own catalog, ``tpch_catalog(scale_rows=200_000,
block_rows=32, seed=0)``, built by both packages from the same numpy seed
(the port's with ``device="cpu"``).  The contract inside the port is the
reference's: the advisory PilotFrame is flagged as such, and the terminal
FinalFrame IS the delivered answer object, bitwise the non-streaming answer
of an equal-seed session — solo, in a shared-pilot herd, with batched
finals, cached, staged, over 1 / 2 / 4 shards and fused.

Where a case compares two runs, the port is also held to the reference:
frame kinds and their order equal; the advisory estimates and their CI
half-widths within rtol 1e-5 (the pilot block sums are f32 sums whose last
bit may differ between the two packages); the result cache's
``bytes_used`` equal exactly.

The reference's four gateway cases (``test_gateway_*``) wait for the port's
serving gateway (ROADMAP queue 1 item 10 (c)).
"""

import dataclasses as dc
import functools
import math

import numpy as np
import pytest

import repro.api as ref_api
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro_torch.api import (ErrorFrame, ExactFrame, FinalFrame, PilotFrame,
                             SessionConfig)
from repro_torch.api import Session as _Session
from repro_torch.core.taqa import advisory_estimate
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.kernels.filtered_agg import filtered_agg_batched
from repro_torch.stream import Frame, FrameBuffer

Session = functools.partial(_Session, device="cpu")

HERD_SQL = ("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
            "WHERE l_quantity < 24 ERROR 8% CONFIDENCE 95%")
# post-aggregation clauses (HAVING / ORDER BY / LIMIT) go before the spec
GROUPED_TEMPLATE = ("SELECT SUM(l_quantity) AS q, COUNT(*) AS n FROM "
                    "lineitem WHERE l_quantity < 30 GROUP BY l_returnflag "
                    "MAXGROUPS 3{suffix} ERROR 10% CONFIDENCE 90%")
BATCH_TEMPLATE = ("SELECT SUM(l_extendedprice) AS rev FROM lineitem "
                  "WHERE l_quantity < {} ERROR 10% CONFIDENCE 90%")
CUTS = [18, 24, 30, 36]

SERIAL_CFG = SessionConfig(async_workers=0, share_pilots=False,
                           result_cache_size=0)
NOCACHE_CFG = SessionConfig(async_workers=4, result_cache_size=0)
REF_SERIAL = ref_api.SessionConfig(async_workers=0, share_pilots=False,
                                   result_cache_size=0)
REF_NOCACHE = ref_api.SessionConfig(async_workers=4, result_cache_size=0)


@pytest.fixture(scope="module")
def catalogs():
    return (ref_tpch_catalog(scale_rows=200_000, block_rows=32, seed=0),
            tpch_catalog(scale_rows=200_000, block_rows=32, seed=0,
                         device="cpu"))


@pytest.fixture(scope="module")
def catalog(catalogs):
    return catalogs[1]


def _assert_bitwise(answer_a, answer_b):
    assert np.array_equal(answer_a.values, answer_b.values)
    assert np.array_equal(answer_a.group_present, answer_b.group_present)
    assert list(answer_a.names) == list(answer_b.names)


def _kinds(frames):
    return [f.kind for f in frames]


def _assert_advisory_close(port_frame, ref_frame):
    """A port pilot frame against the reference's: the same shape, flags
    and pilot size, estimates and half-widths within rtol 1e-5."""
    assert port_frame.kind == ref_frame.kind == "pilot"
    assert port_frame.names == ref_frame.names
    assert port_frame.n_pilot_blocks == ref_frame.n_pilot_blocks
    assert port_frame.confidence == ref_frame.confidence
    assert (port_frame.shared, port_frame.from_cache) == \
        (ref_frame.shared, ref_frame.from_cache)
    np.testing.assert_array_equal(port_frame.group_present,
                                  ref_frame.group_present)
    np.testing.assert_allclose(port_frame.values, ref_frame.values, rtol=1e-5)
    np.testing.assert_allclose(port_frame.half_widths, ref_frame.half_widths,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# FrameBuffer mechanics
# ---------------------------------------------------------------------------

def test_frame_buffer_orders_and_closes():
    buf = FrameBuffer(7)
    buf.push(Frame(query_id=7))
    f2 = buf.push(ErrorFrame(query_id=7, error="x"))
    assert [f.seq for f in buf.frames()] == [0, 1]
    assert buf.closed and f2.terminal
    # post-terminal pushes are no-ops: the stream already ended
    buf.push(Frame(query_id=7))
    assert len(buf.frames()) == 2
    # iterating a finished stream terminates without blocking
    assert [f.seq for f in buf.stream()] == [0, 1]


def test_frames_carry_monotone_emitted_at(catalog):
    s = Session(catalog, seed=3, config=SERIAL_CFG)
    h = s.sql(HERD_SQL, stream=True)
    frames = list(h.stream())
    assert len(frames) == 2
    stamps = [f.emitted_at for f in frames]
    assert all(t >= 0.0 for t in stamps)
    assert stamps == sorted(stamps)  # monotone in seq
    # emitted_at is the t_emit clock rebased to the handle's submit epoch
    for f in frames:
        assert f.emitted_at == f.t_emit - h.t_submit
    # a standalone buffer (no explicit t0) self-anchors at construction
    buf = FrameBuffer(9)
    f = buf.push(Frame(query_id=9))
    assert f.emitted_at >= 0.0


def test_frame_buffer_callback_replays_backlog():
    buf = FrameBuffer(1)
    early = Frame(query_id=1)
    buf.push(early)
    seen = []
    buf.add_callback(seen.append)
    assert seen == [early]  # late subscription replays, in order
    late = ErrorFrame(query_id=1, error="e")
    buf.push(late)
    assert seen == [early, late]


def test_frame_buffer_stream_timeout():
    buf = FrameBuffer(2)
    with pytest.raises(TimeoutError):
        next(buf.stream(timeout=0.01))


# ---------------------------------------------------------------------------
# Solo path: frame shape, advisory flags, bitwise final
# ---------------------------------------------------------------------------

def test_solo_stream_pilot_then_bitwise_final(catalogs):
    ref_cat, catalog = catalogs
    plain = Session(catalog, seed=3, config=SERIAL_CFG).sql(HERD_SQL)
    assert plain.fallback is None

    s = Session(catalog, seed=3, config=SERIAL_CFG)
    h = s.sql(HERD_SQL, stream=True)
    frames = list(h.stream())
    assert [type(f) for f in frames] == [PilotFrame, FinalFrame]
    pf, ff = frames
    assert pf.advisory and not pf.terminal
    assert ff.terminal and not ff.advisory
    assert [f.seq for f in frames] == [0, 1]
    assert pf.t_emit < ff.t_emit
    # the terminal frame IS the delivered answer object
    assert ff.answer is h.answer
    _assert_bitwise(ff.answer, plain.answer)
    rel = abs(pf.scalar("rev") - ff.scalar("rev")) / abs(ff.scalar("rev"))
    assert rel < 0.5
    assert math.isfinite(pf.half_width("rev")) and pf.half_width("rev") > 0
    assert pf.n_pilot_blocks == h.report.n_pilot_blocks
    assert pf.confidence == 0.95
    # frames hold host numpy, never a tensor
    assert isinstance(pf.values, np.ndarray)
    assert isinstance(pf.half_widths, np.ndarray)

    ref = ref_api.Session(ref_cat, seed=3, config=REF_SERIAL).sql(
        HERD_SQL, stream=True)
    assert _kinds(frames) == _kinds(ref.frames())
    _assert_advisory_close(pf, ref.frames()[0])
    np.testing.assert_allclose(ff.answer.values, ref.answer.values, rtol=1e-5)


def test_stream_false_is_nonstreaming_default(catalog):
    s = Session(catalog, seed=3, config=SERIAL_CFG)
    h = s.sql(HERD_SQL)
    assert not h.streaming and h.frames() == []
    # enabling after the fact synthesizes a complete single-frame stream
    frames = list(h.stream())
    assert len(frames) == 1 and frames[0].terminal
    assert frames[0].answer is h.answer


def test_advisory_estimate_matches_hand_computed_t_interval(catalogs):
    """The SUM channel's estimate is the Hájek total with a two-sided
    t-interval on the pilot block sums — checked against a hand computation
    from the same PilotOutcome, and against the reference's estimate."""
    from repro.core.taqa import advisory_estimate as ref_advisory_estimate
    from repro_torch.stats import student_t_ppf
    ref_cat, catalog = catalogs
    s = Session(catalog, seed=3, config=SERIAL_CFG)
    hq = s.prepare(HERD_SQL)
    outcome = s.db.run_pilot(hq.query, hq.spec, s._pilot_seed_for(hq))
    est = advisory_estimate(hq.query, outcome, hq.spec.confidence)
    bs = np.asarray(outcome.pilot.block_sums, dtype=np.float64)
    n_p, N = bs.shape[0], float(outcome.pilot.n_total_blocks)
    idx = outcome.comp_channels[0][0]
    want_val = N * bs[:, 0, idx].mean()
    t_q = student_t_ppf(1.0 - 0.025, n_p - 1)
    want_hw = N * t_q / np.sqrt(n_p) * bs[:, 0, idx].std(ddof=1)
    assert est.scalar("rev") == pytest.approx(want_val, rel=1e-12)
    assert est.half_width("rev") == pytest.approx(want_hw, rel=1e-12)
    assert est.n_pilot_blocks == outcome.pilot.n_sampled_blocks

    rs = ref_api.Session(ref_cat, seed=3, config=REF_SERIAL)
    rq = rs.prepare(HERD_SQL)
    assert rs._pilot_seed_for(rq) == s._pilot_seed_for(hq)
    r_out = rs.db.run_pilot(rq.query, rq.spec, rs._pilot_seed_for(rq))
    r_est = ref_advisory_estimate(rq.query, r_out, rq.spec.confidence)
    assert est.names == r_est.names
    assert est.n_pilot_blocks == r_est.n_pilot_blocks
    assert est.theta_pilot == r_est.theta_pilot
    np.testing.assert_allclose(est.values, r_est.values, rtol=1e-5)
    np.testing.assert_allclose(est.half_widths, r_est.half_widths, rtol=1e-5)
    assert est.nbytes() == r_est.nbytes()


def test_error_frame_on_captured_failure(catalog):
    s = Session(catalog, seed=3, config=SERIAL_CFG)
    h = s.submit("SELECT COUNT(*) AS n FROM not_a_table GROUP BY g",
                 stream=True)
    s.drain()
    assert h.status == "failed"
    frames = list(h.stream())
    assert len(frames) == 1 and isinstance(frames[0], ErrorFrame)
    assert frames[0].terminal and frames[0].error == h.error


# ---------------------------------------------------------------------------
# Herd / shared pilot / batched finals
# ---------------------------------------------------------------------------

def test_herd_stream_shared_pilot_fanout_before_stage2(catalogs):
    """Every herd member streams the shared pilot's advisory frame, and ALL
    pilot frames are emitted before ANY final frame."""
    ref_cat, catalog = catalogs
    solo = Session(catalog, seed=11, config=SERIAL_CFG).sql(HERD_SQL)
    rt = Session(catalog, seed=11, config=NOCACHE_CFG)
    handles = [rt.submit(HERD_SQL, stream=True) for _ in range(5)]
    p0 = rt.executor.pilots_run
    rt.drain()
    assert rt.executor.pilots_run - p0 == 1  # streaming kept pilot sharing
    pilot_emits, final_emits = [], []
    for h in handles:
        frames = h.frames()
        assert [type(f) for f in frames] == [PilotFrame, FinalFrame]
        assert frames[0].shared  # fanned out from a shared pilot stage
        pilot_emits.append(frames[0].t_emit)
        final_emits.append(frames[1].t_emit)
        _assert_bitwise(frames[1].answer, solo.answer)
    assert max(pilot_emits) < min(final_emits)
    vals = {h.frames()[0].scalar("rev") for h in handles}
    assert len(vals) == 1
    stats = rt.scheduler.last_drain
    assert stats.frames_emitted == 10
    assert 0 < stats.time_to_first_frame_s < stats.time_to_final_s
    rt.close()

    ref = ref_api.Session(ref_cat, seed=11, config=REF_NOCACHE)
    ref_handles = [ref.submit(HERD_SQL, stream=True) for _ in range(5)]
    ref.drain()
    for h, r in zip(handles, ref_handles):
        assert _kinds(h.frames()) == _kinds(r.frames())
        _assert_advisory_close(h.frames()[0], r.frames()[0])
    assert ref.scheduler.last_drain.frames_emitted == stats.frames_emitted
    ref.close()


def test_batched_finals_stream_bitwise(catalog):
    """A constant-varied herd (batched finals, one pilot per constant)
    streams per-member FinalFrames bitwise the solo runs', through one
    batched kernel launch."""
    serial = Session(catalog, seed=9, config=SERIAL_CFG)
    want = {c: serial.sql(BATCH_TEMPLATE.format(c)).answer for c in CUTS}

    rt = Session(catalog, seed=9, config=NOCACHE_CFG)
    handles = {c: rt.submit(BATCH_TEMPLATE.format(c), stream=True)
               for c in CUTS}
    calls0 = filtered_agg_batched.calls
    rt.drain()
    assert filtered_agg_batched.calls > calls0  # the finals batched
    for c, h in handles.items():
        assert h.status == "done"
        ff = h.frames()[-1]
        assert ff.terminal
        _assert_bitwise(ff.answer, want[c])
    rt.close()


def test_mixed_streaming_and_plain_members_bitwise(catalog):
    solo = Session(catalog, seed=11, config=SERIAL_CFG).sql(HERD_SQL)
    rt = Session(catalog, seed=11, config=NOCACHE_CFG)
    hs = rt.submit(HERD_SQL, stream=True)
    hp = rt.submit(HERD_SQL)
    rt.drain()
    assert not hp.streaming and hp.frames() == []
    _assert_bitwise(hs.answer, solo.answer)
    _assert_bitwise(hp.answer, solo.answer)
    rt.close()


def test_on_frame_callback_and_late_subscription(catalog):
    s = Session(catalog, seed=3, config=SERIAL_CFG)
    live = []
    h = s.prepare(HERD_SQL, stream=True)
    h.on_frame(live.append)
    s.scheduler.submit(h)
    s.drain()
    assert [type(f) for f in live] == [PilotFrame, FinalFrame]
    replay = []
    h.on_frame(replay.append)
    assert [f.seq for f in replay] == [f.seq for f in live]


# ---------------------------------------------------------------------------
# Cached re-issues
# ---------------------------------------------------------------------------

def test_cached_stream_replays_pilot_summary(catalogs):
    ref_cat, catalog = catalogs
    s = Session(catalog, seed=13)
    first = s.sql(HERD_SQL, stream=True)
    assert not first.cached
    again = s.sql(HERD_SQL, stream=True)
    assert again.cached
    frames = again.frames()
    assert [type(f) for f in frames] == [PilotFrame, FinalFrame]
    assert frames[0].from_cache  # replayed from the CachedAnswer record
    assert frames[1].cached
    assert frames[0].scalar("rev") == first.frames()[0].scalar("rev")
    _assert_bitwise(frames[1].answer, first.frames()[1].answer)
    s.close()

    rs = ref_api.Session(ref_cat, seed=13)
    rs.sql(HERD_SQL, stream=True)
    r_again = rs.sql(HERD_SQL, stream=True)
    assert _kinds(frames) == _kinds(r_again.frames())
    _assert_advisory_close(frames[0], r_again.frames()[0])
    rs.close()


def test_cached_entry_without_pilot_streams_single_frame(catalog):
    s = Session(catalog, seed=13)
    sql = "SELECT COUNT(*) AS n FROM lineitem"  # no spec: requested exact
    first = s.sql(sql)
    assert first.fallback is not None
    again = s.sql(sql, stream=True)
    assert again.cached
    frames = again.frames()
    assert len(frames) == 1 and isinstance(frames[0], ExactFrame)
    s.close()


def test_result_cache_bytes_account_for_pilot_summary(catalogs):
    """CachedAnswer.nbytes() charges the recorded pilot summary, and the
    byte meter equals the reference's exactly."""
    from repro_torch.runtime import CachedAnswer
    ref_cat, catalog = catalogs
    s = Session(catalog, seed=13)
    h = s.sql(HERD_SQL, stream=True)
    base = CachedAnswer.from_answer(h.answer)
    entry = s.result_cache.get(s._cache_key(h))
    assert entry.pilot is not None
    assert entry.nbytes() == base.nbytes() + entry.pilot.nbytes()
    assert entry.pilot.nbytes() < 4096  # compact: summaries, not matrices
    assert s.result_cache_info().bytes_used >= entry.nbytes()

    rs = ref_api.Session(ref_cat, seed=13)
    rs.sql(HERD_SQL, stream=True)
    assert s.result_cache_info().bytes_used == rs.result_cache_info().bytes_used
    s.close()
    rs.close()


# ---------------------------------------------------------------------------
# HAVING + ORDER BY/LIMIT matrix (streamed vs plain, cached, dist)
# ---------------------------------------------------------------------------

_SUFFIXES = [
    "",
    " HAVING q >= 100",
    " ORDER BY q DESC LIMIT 2",
    " HAVING q >= 100 ORDER BY q ASC LIMIT 1",
]


@pytest.mark.parametrize("suffix", _SUFFIXES)
def test_having_limit_matrix_streamed_bitwise(catalog, suffix):
    sql = GROUPED_TEMPLATE.format(suffix=suffix)
    plain = Session(catalog, seed=21, config=SERIAL_CFG).sql(sql)
    s = Session(catalog, seed=21, config=SERIAL_CFG)
    h = s.sql(sql, stream=True)
    ff = h.frames()[-1]
    assert ff.terminal and ff.answer is h.answer
    # the frame carries the POST-HAVING/LIMIT delivered answer
    _assert_bitwise(ff.answer, plain.answer)


@pytest.mark.parametrize("suffix", _SUFFIXES)
def test_having_limit_matrix_cached_stream_bitwise(catalog, suffix):
    s = Session(catalog, seed=22)
    sql = GROUPED_TEMPLATE.format(suffix=suffix)
    first = s.sql(sql)
    again = s.sql(sql, stream=True)
    assert again.cached
    _assert_bitwise(again.frames()[-1].answer, first.answer)
    s.close()


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_shard_counts_stream_bitwise(catalog, shards):
    sql = GROUPED_TEMPLATE.format(
        suffix=" HAVING q >= 100 ORDER BY q DESC LIMIT 2")
    mono = Session(catalog, seed=31, config=SERIAL_CFG).sql(sql)
    s = Session(seed=31, config=SERIAL_CFG)
    for name, tab in catalog.items():
        if name == "lineitem":
            s.register_table(name, tab, shards=shards)
        else:
            s.register_table(name, tab)
    h = s.sql(sql, stream=True)
    frames = h.frames()
    assert frames[-1].terminal
    if mono.fallback is None:
        assert isinstance(frames[0], PilotFrame)  # dist pilots stream too
    _assert_bitwise(frames[-1].answer, mono.answer)


def test_staged_stream_bitwise(catalog):
    def _run(rates, stream):
        s = Session(seed=41, config=SERIAL_CFG)
        for name, tab in catalog.items():
            s.register_table(name, tab,
                             staged_rates=rates if name == "lineitem"
                             else None)
        h = s.sql(HERD_SQL, stream=stream)
        hits = s.executor.staged_info()["hits"]
        return h, hits

    ref, _ = _run([1e-9], stream=False)     # ladder that never serves
    hot, hits = _run(True, stream=True)     # default ladder, streamed
    assert hits > 0
    frames = hot.frames()
    assert isinstance(frames[0], PilotFrame) and frames[-1].terminal
    _assert_bitwise(frames[-1].answer, ref.answer)


# ---------------------------------------------------------------------------
# The fused program streams its terminal frame only (as in the reference)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drained", [False, True])
def test_fused_stream_bitwise(catalogs, drained):
    ref_cat, catalog = catalogs
    fused_cfg = dc.replace(SERIAL_CFG, fused_taqa=True)
    plain = Session(catalog, seed=7, config=SERIAL_CFG).sql(HERD_SQL)
    s = Session(catalog, seed=7, config=fused_cfg)
    if drained:
        h = s.submit(HERD_SQL, stream=True)
        s.drain()
    else:
        h = s.sql(HERD_SQL, stream=True)
    assert h._fused
    frames = list(h.stream())
    assert frames[-1].answer is h.answer
    _assert_bitwise(h.answer, plain.answer)

    rs = ref_api.Session(ref_cat, seed=7,
                         config=dc.replace(REF_SERIAL, fused_taqa=True))
    r = rs.sql(HERD_SQL, stream=True)
    assert r._fused
    assert _kinds(frames) == _kinds(r.frames()) == ["final"]
