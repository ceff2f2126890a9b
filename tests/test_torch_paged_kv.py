"""The port's paged pool bookkeeping against the reference's.

``BlockManager`` is host-only logic copied from ``repro.serve.paged_kv``:
the same random operation sequence (alloc / free / fork / CoW write /
spill / restore / window free) drives one reference and one port manager,
and after every operation both hold the same free list, the same
refcounts and hand out the same block ids.  ``StatePool`` page movement
(spill -> archive -> restore) must give back exactly the pages it took.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.serve import paged_kv as ref_kv  # noqa: E402
from repro_torch.api.errors import ServePlanError  # noqa: E402
from repro_torch.configs.base import (ModelConfig, RGLRUConfig,  # noqa: E402
                                      get_config)
from repro_torch.core.kvcache import HostArchive  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.serve.paged_kv import (BlockManager,  # noqa: E402
                                        NoFreeBlocks, PagedKVConfig,
                                        StatePool, blocks_for)


def _pair(num_blocks):
    cfg = dict(block_size=4, num_blocks=num_blocks)
    return (ref_kv.BlockManager(ref_kv.PagedKVConfig(**cfg)),
            BlockManager(PagedKVConfig(**cfg), HostArchive("cpu")))


def _same(ref, port):
    assert port._free == ref._free
    assert np.array_equal(port._ref, ref._ref)
    assert (port.forked_blocks, port.cow_faults) == (ref.forked_blocks,
                                                     ref.cow_faults)


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_block_manager_matches_reference_under_random_ops(data):
    num_blocks = data.draw(st.integers(4, 24), label="num_blocks")
    ref, port = _pair(num_blocks)
    tables = []                                  # shared by both managers
    spilled = {}                                 # key -> page count

    for _ in range(data.draw(st.integers(5, 40), label="n_ops")):
        op = data.draw(st.sampled_from(
            ["alloc", "free", "fork", "cow_write", "spill", "restore",
             "window_free"]), label="op")
        if op == "alloc":
            n = data.draw(st.integers(1, 4))
            if port.can_alloc(n):
                t = port.alloc(n)
                assert ref.alloc(n) == t
                tables.append(t)
            else:
                for m in (ref, port):
                    with pytest.raises(Exception) as e:
                        m.alloc(n)
                    assert type(e.value).__name__ == "NoFreeBlocks"
        elif op == "free" and tables:
            t = tables.pop(data.draw(st.integers(0, len(tables) - 1)))
            for m in (ref, port):
                m.free([b for b in t if b])
        elif op == "fork" and tables:
            t = tables[data.draw(st.integers(0, len(tables) - 1))]
            assert ref.fork(t) == port.fork(t)
            tables.append(list(t))
        elif op == "cow_write" and tables:
            ti = data.draw(st.integers(0, len(tables) - 1))
            t = tables[ti]
            live = [i for i, b in enumerate(t) if b]
            if live:
                idx = data.draw(st.sampled_from(live))
                if port.can_alloc(1) or not port.is_shared(t[idx]):
                    got = [m.ensure_writable(list(t), idx, lambda s, d: None)
                           for m in (ref, port)]
                    assert got[0] == got[1]
                    tables[ti] = got[1][0]
        elif op == "spill" and tables:
            t = tables.pop(data.draw(st.integers(0, len(tables) - 1)))
            if any(port.is_shared(b) for b in t):
                for m in (ref, port):
                    m.free([b for b in t if b])
            else:
                key = ("req", len(spilled))
                n = len([b for b in t if b])
                ref.spill(key, t, lambda bids: {"p": jnp.zeros(
                    (1, len(bids), 2))})
                port.spill(key, t, lambda bids: {"p": torch.zeros(
                    1, len(bids), 2)})
                spilled[key] = n
        elif op == "restore" and spilled:
            key = next(iter(spilled))
            if port.can_alloc(spilled[key]):
                got = port.restore(key, lambda pages, bids: None)
                assert ref.restore(key, lambda pages, bids: None) == got
                del spilled[key]
                tables.append(got)
            else:
                with pytest.raises(NoFreeBlocks):
                    port.restore(key, lambda pages, bids: None)
                assert port.spilled(key)
        elif op == "window_free" and tables:
            t = tables[data.draw(st.integers(0, len(tables) - 1))]
            for i in range(data.draw(st.integers(0, len(t)))):
                if t[i]:
                    for m in (ref, port):
                        m.free([t[i]])
                    t[i] = 0
        _same(ref, port)


def _pool(num_blocks):
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    pcfg = PagedKVConfig(block_size=2, num_blocks=num_blocks,
                         max_blocks_per_req=4, dtype="float32")
    return cfg, pcfg, StatePool(cfg, pcfg, device="cpu")


def test_spill_restore_roundtrip_preserves_pages():
    cfg, pcfg, pool = _pool(8)
    m = BlockManager(pcfg, HostArchive("cpu"))
    table = m.alloc(2)
    for a in tree_leaves(pool.state):
        a.normal_(generator=torch.Generator().manual_seed(0))
    want = [a.clone() for a in tree_leaves(pool.extract_pages(table))]
    m.spill(("req", 0), table, pool.extract_pages)
    assert m.num_free == 7 and m.archive.nbytes() > 0
    for a in tree_leaves(pool.state):
        a.zero_()                        # restore must really rewrite
    new_table = m.restore(("req", 0), pool.insert_pages)
    got = tree_leaves(pool.extract_pages(new_table))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert m.archive.nbytes() == 0
    # a CoW copy duplicates one page in every layer and leaf
    pool.copy_page(new_table[0], 7)
    for a in tree_leaves(pool.state):
        assert torch.equal(a[:, 7], a[:, new_table[0]])


def test_restore_without_space_keeps_archive():
    cfg, pcfg, pool = _pool(4)
    m = BlockManager(pcfg, HostArchive("cpu"))
    m.spill(("req", 1), m.alloc(2), pool.extract_pages)
    m.alloc(3)
    with pytest.raises(NoFreeBlocks):
        m.restore(("req", 1), pool.insert_pages)
    assert m.spilled(("req", 1))


def test_pool_accounting_and_unservable_mixers():
    cfg, pcfg, pool = _pool(16)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    assert pool.hbm_bytes() == cfg.num_layers * 2 * 16 * 2 * kv * hd * 4
    assert blocks_for(5, 4) == 2 and blocks_for(4, 4) == 1
    # every mixer kind of the reference registers a MixerSpec (RG-LRU and
    # LOCAL_ATTN since recurrentgemma-2b): the hybrid is servable, with
    # slot state beside windowed pages; a kind with no spec is refused
    hybrid = ModelConfig(name="hybrid", family="hybrid", num_layers=3,
                         d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
                         vocab_size=256, rglru=RGLRUConfig())
    layout = StatePool(hybrid, pcfg, device="cpu").layout
    assert layout.has_slot_state and layout.has_windowed_state
    assert layout.free_window == hybrid.sliding_window
    bogus = dataclasses.replace(hybrid, rglru=RGLRUConfig(
        block_pattern=("rglru", "bogus", "local")))
    with pytest.raises(ServePlanError, match="'bogus'.*MixerSpec"):
        StatePool(bogus, pcfg, device="cpu")
