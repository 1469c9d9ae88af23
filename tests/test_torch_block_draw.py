"""The ``block_draw`` kernel's arithmetic and the device draw's path, on the
CPU: numpy's PCG64 stream by jumps, the kernel's jump table, the plain
draw against the host draw, and the sessions' paths through the device
draw's entry point (its CPU route) against the host draw, bitwise.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.api import Session, SessionConfig
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.core import taqa
from repro_torch.engine import executor
from repro_torch.engine.sampling import (BlockDraw, draw_block_ids, draw_block_ids_device,
                                         pad_block_ids)
from repro_torch.kernels import block_draw as block_draw_pkg
from repro_torch.kernels.block_draw import block_draw, block_draw_ref, pcg64_state
from repro_torch.kernels.block_draw import ref

SF10_BLOCKS, SF100_BLOCKS = 1_875_000, 9_375_000
OFFSETS = sorted({0, 1, SF10_BLOCKS - 1, SF100_BLOCKS - 1}
                 | {(1 << k) + e for k in range(1, 24) for e in (-1, 1)})
CU = Path(block_draw_pkg.__file__).parent / "csrc" / "block_draw.cu"


@pytest.mark.parametrize("seed", [0, 1, 123, 2 ** 31 + 5, 3_400_100_001, 2 ** 62 + 11])
def test_jump_ahead_is_numpys_stream(seed):
    """Uniform i by a jump from the seed's state is ``default_rng(seed)``'s
    uniform i, up to SF100's last block."""
    u = np.random.default_rng(seed).random(SF100_BLOCKS)
    state, inc = pcg64_state(seed)
    got = [ref.uniform_at(state, inc, i) for i in OFFSETS]
    assert got == [float(u[i]) for i in OFFSETS]


def test_the_kernels_jump_table_is_the_plain_versions():
    body = re.search(r"kJump\[kJumps\]\[4\] = \{(.*?)\n\};", CU.read_text(), re.S).group(1)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)ull", body)]
    rows = [words[i:i + 4] for i in range(0, len(words), 4)]
    want = [(a & (2 ** 64 - 1), a >> 64, g & (2 ** 64 - 1), g >> 64)
            for a, g in ref.jump_table()]
    assert [tuple(r) for r in rows] == want and len(want) == ref.JUMPS
    consts = dict(re.findall(r"constexpr int (kThreads|kChunk|kJumps) = (\d+);", CU.read_text()))
    assert (int(consts["kChunk"]), int(consts["kJumps"])) == (ref.CHUNK, ref.JUMPS)
    assert int(consts["kThreads"]) * ref.CHUNK == block_draw_pkg.ops.TILE


@pytest.mark.parametrize("n", [1, 63, 64, 65, 100_003])
@pytest.mark.parametrize("rate", [0.0, 1e-6, 0.003, 0.1, 0.5, 1.0])
def test_plain_draw_is_the_host_draw_padded(rate, n):
    """The plain draw, and the device draw's entry point on its CPU route:
    ids, count and padded length of ``pad_block_ids(draw_block_ids(...))``,
    zeros from the count to the padded length."""
    seed = 3_500_000_017 + n
    phys, n_real, n_phys = pad_block_ids(draw_block_ids(n, rate, seed), n)
    count, ids = block_draw_ref(n, rate, *pcg64_state(seed))
    assert int(count) == n_real
    np.testing.assert_array_equal(ids[:n_phys].numpy(), phys)
    assert not ids[n_phys:].any()
    calls = block_draw.calls
    d = draw_block_ids_device(n, rate, seed, "cpu")
    assert block_draw.calls == calls + 1
    assert (d.n_real, d.n_phys, d.phys) == (n_real, n_phys, None)
    np.testing.assert_array_equal(d.ids_dev.numpy(), phys)
    assert d.ids_dev.numel() == n_phys and d.ids_dev.is_contiguous()
    assert d.ids_dev.untyped_storage().nbytes() == 4 * n_phys  # a tensor of its own
    assert d.ids is None
    info = d.sample_info(rate, seed, n, 0)
    info.settle()
    assert info.pending_ids is None and (info.n_sampled_blocks, info.n_total_blocks) == (n_real, n)
    np.testing.assert_array_equal(info.sampled_block_ids, phys[:n_real])


@pytest.mark.parametrize("rate", [0.0, 0.003, 1.0])
def test_draw_blocks_of_a_host_table_is_the_host_draw(rate):
    """A table on the CPU draws on the host: the ids as drawn, padded as
    ``pad_block_ids`` pads them, and a SampleInfo that holds the drawn ids
    and has nothing to settle."""
    catalog = tpch_catalog(20_000, 32, seed=0, device="cpu")
    table = catalog["lineitem"]
    calls = block_draw.calls
    d = executor.draw_blocks(table, rate, 77)
    assert block_draw.calls == calls
    want = draw_block_ids(table.num_blocks, rate, 77)
    phys, n_real, n_phys = pad_block_ids(want, table.num_blocks)
    assert isinstance(d, BlockDraw) and d.ids_dev is None
    assert (d.n_real, d.n_phys) == (n_real, n_phys)
    np.testing.assert_array_equal(d.phys, phys)
    info = d.sample_info(rate, 77, table.num_blocks, 123)
    assert info.pending_ids is None
    info.settle()
    assert info.pending_ids is None and info.scanned_bytes == 123
    np.testing.assert_array_equal(info.sampled_block_ids, want)


def test_block_draw_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        block_draw(-1, 0.1, 1, 1, "cpu")
    with pytest.raises(ValueError):
        block_draw(2 ** 31, 0.1, 1, 1, "cpu")
    with pytest.raises(ValueError):
        block_draw(10, 0.1, 1 << 128, 1, "cpu")
    with pytest.raises(ValueError):
        draw_block_ids_device(10, 0.1, -1, "cpu")  # numpy refuses the seed too


Q6 = ("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
      "WHERE l_quantity < {c} ERROR {e}% CONFIDENCE 95%")
SC = ("SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem "
      "ERROR {e}% CONFIDENCE 95%")
Q1 = ("SELECT SUM(l_quantity) AS q, COUNT(*) AS n FROM lineitem "
      "WHERE l_shipdate < {x} GROUP BY l_returnflag ERROR 15% CONFIDENCE 90%")
HERD = ([Q6.format(c=c, e=8) for c in (18, 21, 24, 27)] + [SC.format(e=e) for e in (5, 6, 7)]
        + [Q1.format(x=x) for x in (1800, 2000, 2200)])


def _run(catalog, device_draws, monkeypatch):
    """The herd drained (stacked pilots, batched finals) and asked one by
    one (solo pilots and finals), traced; with ``device_draws`` every draw
    of those paths goes through the device draw's entry point."""
    if device_draws:
        for module in (executor, taqa):
            monkeypatch.setattr(module, "draw_blocks", lambda table, rate, seed:
                                draw_block_ids_device(table.num_blocks, rate, seed,
                                                      table.device))
    cfg = dict(result_cache_size=0, async_workers=0, tracing=True)
    s = Session(catalog, seed=21, device="cpu", config=SessionConfig(**cfg))
    serial = Session(catalog, seed=21, device="cpu",
                     config=SessionConfig(**cfg, share_pilots=False))
    finals, wheres = [], []
    for sess in (s, serial):
        execute, execute_batch = sess.executor.execute, sess.executor.execute_batch

        def keep(res):
            for t, i in getattr(res, "sample_infos", {}).items():
                if i.method == "block":
                    finals.append((t, i.n_sampled_blocks, i.sampled_block_ids.tolist()))
            return res

        sess.executor.execute = lambda plan, _e=execute: keep(_e(plan))
        sess.executor.execute_batch = lambda plans, on_result=None, _b=execute_batch: [
            keep(r) for r in _b(plans, on_result=on_result)]
    try:
        hs = [s.submit(q) for q in HERD]
        s.drain()
        hs += [serial.sql(q) for q in HERD]
        assert all(h.status == "done" for h in hs), [h.error for h in hs]
        for h in hs:
            wheres += [d.attrs["where"] for d in h._trace.find("draw")]
        return [h.answer.values.tobytes() for h in hs], finals, wheres
    finally:
        s.close()
        serial.close()


def test_device_draw_path_is_the_host_draw_bitwise(monkeypatch):
    """Solo and stacked pilots, solo and batched finals, through the device
    draw's entry point: the same answers bit for bit and the same final
    ids as the host draw, and every ``draw`` span says where it ran."""
    catalog = tpch_catalog(200_000, 32, seed=0, device="cpu")
    calls = block_draw.calls
    host = _run(catalog, False, monkeypatch)
    assert block_draw.calls == calls
    dev = _run(catalog, True, monkeypatch)
    assert block_draw.calls > calls
    assert dev[0] == host[0] and dev[1] == host[1] and host[1]
    assert set(host[2]) == {"host"} and set(dev[2]) == {"device"}
    assert len(dev[2]) == len(host[2])
