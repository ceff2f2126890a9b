"""The port's HyperShard derivation against the reference's, on the CPU.

Pure derivation, no process group (but the last two tests):

- every param leaf of all eleven archs, full size and reduced, on the
  layouts (1, 1), (2, 4), (16, 16) and (2, 16, 16) under fsdp_tp, tp_only
  (``fsdp=None``) and ``moe_weights="dp"``: the port's spec, the DTensor
  placements it becomes read back as a spec, the rule that fired and the
  fallback notes all equal the reference's ``derive_param``, exactly, and
  every sharded dim divides (DTensor would chunk an uneven one, JAX never
  does);
- ``derive_cache`` and ``derive_pool`` on a grid over the reference
  test's leaves and shapes (``tests/test_hypershard.py``): spec, branch
  note and fallbacks equal;
- the reference's property tests, as cases on the port;
- a dim sharded over two axes chunks the same way under DTensor's
  placements as under JAX's ``NamedSharding`` on a forced eight-device
  mesh;
- ``constrain``: the identity with no mesh or on a plain tensor, the
  filter that drops axes the mesh lacks, the divisibility skip, size-1
  mesh dims as ``Replicate``, and a one-rank gloo mesh.
"""
import dataclasses
import json
import types

import jax
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import list_archs  # noqa: E402
from repro.core import hypershard as jhs  # noqa: E402
from repro.core.layout import Layout as JaxLayout  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import hypershard as hs, meshctx  # noqa: E402
from repro_torch.core.layout import (Layout, LayoutError,  # noqa: E402
                                     placements_for, spec_of)
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.mem.planner import param_shapes  # noqa: E402
from tests.conftest import run_subprocess  # noqa: E402

LAYOUTS = (((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
           ((16, 16), ("data", "model")),
           ((2, 16, 16), ("pod", "data", "model")))
PLANS = {"fsdp_tp": {}, "tp_only": {"fsdp": None},
         "moe_dp": {"moe_weights": "dp"}}
LAYOUT = Layout((2, 16, 16), ("pod", "data", "model"))
PLAN = hs.ShardingPlan()


def _reference_leaves(arch, reduced):
    cfg = jax_get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    shapes = jax.eval_shape(lambda: JM.init_model(cfg, jax.random.PRNGKey(0)))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp), tuple(v.shape)) for kp, v in flat]


def _port_leaves(arch, reduced):
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    return [(p, tuple(t.shape))
            for p, t in tree_flatten_with_path(param_shapes(cfg))]


def _divides(spec, shape, layout):
    for dim, entry in zip(shape, spec):
        n = 1
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            n *= layout.axis_size(a)
        if dim % n:
            return False
    return True


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_derivation_equals_reference(arch, reduced):
    leaves = _port_leaves(arch, reduced)
    assert leaves == _reference_leaves(arch, reduced)
    for shape, names in LAYOUTS:
        layout, jlayout = Layout(shape, names), JaxLayout(shape, names)
        for plan_kw in PLANS.values():
            plan = hs.ShardingPlan(**plan_kw)
            jplan = jhs.ShardingPlan(**plan_kw)
            for path, dims in leaves:
                strat, rule, notes = hs.derive_param(path, dims, layout, plan)
                jstrat, jrule, jnotes = jhs.derive_param(path, dims, jlayout,
                                                         jplan)
                want = tuple(jstrat.partition_spec())
                assert strat.partition_spec() == want, (path, shape)
                got = spec_of(placements_for(want, names), names, len(dims))
                assert got == want, (path, shape)
                assert (rule, notes) == (jrule, jnotes), (path, shape)
                assert hs.roles_for_path(path, dims, plan.moe_weights) == \
                    jhs.roles_for_path(path, dims, jplan.moe_weights)
                assert _divides(want, dims, layout), (path, shape)
                assert strat.shard_shape(dims) == jstrat.shard_shape(dims)


def _cache_grid():
    """(path, shape, batch) over the reference test's leaves: dense KV,
    MLA latents, SSD / RG-LRU state and conv tails, at batches and sizes
    that take every branch of the absorption ladder."""
    out = []
    for batch in (1, 2, 16, 32, 128):
        for kv in (1, 2, 8, 16):
            for seq in (64, 100, 8192, 32768):
                out += [("seg0/0/k", (24, batch, seq, kv, 64), batch),
                        ("seg0/0/v", (24, batch, seq, kv, 128), batch)]
        for seq in (64, 100, 32768):
            out += [("seg1/0/ckv", (26, batch, seq, 512), batch),
                    ("seg1/0/krope", (26, batch, seq, 64), batch)]
        for heads in (4, 24, 32):
            out.append(("seg0/0/state", (48, batch, heads, 64, 128), batch))
        out += [("seg0/0/state", (26, batch, 2560), batch),
                ("seg0/0/conv", (48, batch, 3, 1536), batch),
                ("seg0/0/conv", (48, batch, 3, 100), batch)]
    return out


@pytest.mark.parametrize("plan_name", list(PLANS))
def test_cache_and_pool_derivation_equals_reference(plan_name):
    plan = hs.ShardingPlan(**PLANS[plan_name])
    jplan = jhs.ShardingPlan(**PLANS[plan_name])
    for shape, names in LAYOUTS:
        layout, jlayout = Layout(shape, names), JaxLayout(shape, names)
        for path, dims, batch in _cache_grid():
            s, note, fb = hs.derive_cache(path, dims, layout, plan,
                                          batch=batch)
            js, jnote, jfb = jhs.derive_cache(path, dims, jlayout, jplan,
                                              batch=batch)
            assert s.partition_spec() == tuple(js.partition_spec()), path
            assert (note, fb) == (jnote, jfb), (path, dims, shape)
            assert s.divisible(dims)
            s, note, fb = hs.derive_pool(path, dims, layout, plan)
            js, jnote, jfb = jhs.derive_pool(path, dims, jlayout, jplan)
            assert s.partition_spec() == tuple(js.partition_spec()), path
            assert (note, fb) == (jnote, jfb), (path, dims, shape)


def test_reference_examples():
    """The reference's worked cases (tests/test_hypershard.py)."""
    def spec(path, shape, plan=PLAN):
        return hs.param_strategy(path, shape, LAYOUT, plan).partition_spec()
    assert spec("seg0/0/attn/wq", (24, 2048, 2048)) == \
        (None, ("pod", "data"), "model")
    assert spec("seg0/0/attn/wo", (24, 2048, 2048)) == \
        (None, "model", ("pod", "data"))
    assert spec("seg0/0/attn/wq", (24, 100, 2048)) == (None, None, "model")
    assert spec("seg1/0/ffn/w_gate", (26, 64, 2048, 1408)) == \
        (None, "model", ("pod", "data"), None)
    assert spec("embed", (49408, 2048), hs.ShardingPlan(fsdp=None)) == \
        ("model", None)
    assert spec("final_norm", (2048,)) == (None,)
    s = hs.cache_strategy("seg0/0/k", (24, 1, 8192, 2, 64), LAYOUT, PLAN,
                          batch=1)
    assert s.partition_spec() == (None, None, ("pod", "data", "model"),
                                  None, None)


# ---------------------------------------------------------------------------
# the reference's property tests, on the port (LAYOUT sizes: pod=2,
# data=16, model=16; fsdp = pod*data = 32)
# ---------------------------------------------------------------------------
@given(st.integers(1, 4096), st.integers(1, 4096))
@settings(max_examples=150, deadline=None)
def test_param_fallback_drops_axes_outermost_first(d_in, d_out):
    shape = (24, d_in, d_out)
    strat = hs.param_strategy("seg0/0/attn/wq", shape, LAYOUT, PLAN)
    sp = strat.partition_spec()
    if d_in % 32 == 0:
        assert sp[1] == ("pod", "data")
    elif d_in % 16 == 0:
        assert sp[1] == "data"
    else:
        assert sp[1] is None
    assert sp[2] == ("model" if d_out % 16 == 0 else None)
    assert strat.divisible(shape)


@given(st.integers(1, 4096), st.integers(1, 4096))
@settings(max_examples=150, deadline=None)
def test_param_fallback_is_reported(d_in, d_out):
    _, rule, notes = hs.derive_param("seg0/0/attn/wq", (24, d_in, d_out),
                                     LAYOUT, PLAN)
    assert rule is not None
    assert len(notes) == (d_in % 32 != 0) + (d_out % 16 != 0)


@given(st.integers(1, 512), st.integers(1, 64), st.integers(6, 20))
@settings(max_examples=100, deadline=None)
def test_cache_strategy_always_divides(batch, kv, log_seq):
    shape = (24, batch, 2 ** log_seq, kv, 64)
    s = hs.cache_strategy("seg0/0/k", shape, LAYOUT, PLAN, batch=batch)
    assert s.divisible(shape)


@given(st.integers(1, 256), st.integers(1, 64), st.integers(6, 16))
@settings(max_examples=150, deadline=None)
def test_cache_batch_and_seq_absorption_branches(batch, kv, log_seq):
    seq = 2 ** log_seq
    shape = (24, batch, seq, kv, 64)
    sp = hs.cache_strategy("seg0/0/k", shape, LAYOUT, PLAN,
                           batch=batch).partition_spec()
    batch_ok, heads_ok = batch % 32 == 0, kv % 16 == 0
    assert sp[1] == (("pod", "data") if batch_ok else None)
    assert sp[3] == ("model" if heads_ok else None)
    absorbed = (() if batch_ok else ("pod", "data")) + \
        (() if heads_ok else ("model",))
    need = (1 if batch_ok else 32) * (1 if heads_ok else 16)
    if absorbed and seq % need == 0:
        assert sp[2] == (absorbed if len(absorbed) > 1 else absorbed[0])


@given(st.integers(1, 256), st.integers(6, 16))
@settings(max_examples=100, deadline=None)
def test_mla_cache_seq_absorbs_dp_and_tp(batch, log_seq):
    seq = 2 ** log_seq
    sp = hs.cache_strategy("seg1/0/ckv", (26, batch, seq, 512), LAYOUT, PLAN,
                           batch=batch).partition_spec()
    batch_ok = batch % 32 == 0
    absorbed = (() if batch_ok else ("pod", "data")) + ("model",)
    if seq % (16 * (1 if batch_ok else 32)) == 0:
        assert sp[2] == (absorbed if len(absorbed) > 1 else absorbed[0])
    else:
        assert sp[2] is None


@st.composite
def layouts(draw):
    rank = draw(st.integers(1, 3))
    dims = tuple(draw(st.sampled_from([1, 2, 4, 8])) for _ in range(rank))
    return Layout(dims, ("pod", "data", "model")[-rank:])


@given(layouts(), st.data())
@settings(max_examples=100, deadline=None)
def test_shard_shape_conservation_and_placements(layout, data):
    """The reference's layout property: shard shape x shards per dim gives
    the global shape back; the placements read back as the spec."""
    names = layout.alias_name
    entries = []
    free = list(names)
    for _ in range(2):
        k = data.draw(st.integers(0, len(free)))
        axes = tuple(a for a in names if a in free[:k])
        free = [a for a in free if a not in axes]
        entries.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    strat = layout(*entries)
    shape = tuple(n * 3 for n in strat.shards_per_dim())
    local = strat.shard_shape(shape)
    assert tuple(a * b for a, b in zip(local, strat.shards_per_dim())) == shape
    assert spec_of(placements_for(tuple(entries), names), names, 2) == \
        tuple(entries)
    if any(n > 1 for n in strat.shards_per_dim()):
        with pytest.raises(LayoutError):
            strat.shard_shape(tuple(n + 1 if n > 1 else n for n in shape))


def test_layout_errors():
    with pytest.raises(LayoutError):
        Layout((2, 2), ("x",))
    with pytest.raises(LayoutError):
        Layout((2, 2), ("x", "x"))
    with pytest.raises(LayoutError):
        Layout((2, 2), ("x", "y"))("x", "x")
    with pytest.raises(LayoutError):
        placements_for((("model", "data"),), ("data", "model"))


CHUNKS_CODE = """
import json
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
            ("pod", "data", "model"))
sh = NamedSharding(mesh, P(("pod", "data"), "model"))
idx = sh.devices_indices_map((8, 4))
out = {}
for coord in np.ndindex(2, 2, 2):
    s = idx[mesh.devices[coord]]
    out[",".join(map(str, coord))] = [s[0].start or 0, s[1].start or 0]
print("CHUNKS" + json.dumps(out))
"""


def test_two_axis_dims_chunk_as_in_jax():
    """A dim sharded over ("pod", "data"): DTensor's ``Shard(0)`` on both
    mesh dims gives each mesh coordinate the chunk JAX gives it."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    out = run_subprocess(CHUNKS_CODE, devices=8, timeout=300)
    want = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("CHUNKS")][0][6:])
    names = ("pod", "data", "model")
    placements = placements_for((("pod", "data"), "model"), names)
    for key, start in want.items():
        coord = [int(c) for c in key.split(",")]
        local, offset = _compute_local_shape_and_global_offset(
            (8, 4), (2, 2, 2), coord, placements)
        assert list(offset) == start and tuple(local) == (2, 2), key


def test_constrain_filter_and_divisibility():
    """No mesh, or a plain tensor: the identity.  The filter drops axes
    the mesh lacks; a spec that does not divide is skipped."""
    x = torch.zeros(4, 6)
    assert meshctx.constrain(x, "data", "model") is x
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 4))
    assert meshctx._filter_spec(mesh, (("pod", "data"), None, "model",
                                       "pod")) == \
        (("data",), None, "model", None)
    assert meshctx.spec_divides(mesh, (4, 8), ("data", "model"))
    assert not meshctx.spec_divides(mesh, (4, 6), ("data", "model"))
    assert meshctx.spec_divides(mesh, (3, 6), (None, None))
    with meshctx.use_mesh(mesh):
        assert meshctx.current_mesh() is mesh
        assert meshctx.constrain(x, "data", "model") is x
    assert meshctx.current_mesh() is None


def test_constrain_on_a_one_rank_mesh(tmp_path):
    """On a one-rank gloo mesh (the card's mesh in ``chip_smoke.py``):
    every spec becomes ``Replicate`` on the size-1 dims, so ``constrain``
    leaves a replicated DTensor as it is and ``shard_tree`` keeps every
    leaf whole; a plain tensor joins a DTensor op as replicated."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh((1, 1), device="cpu")
        assert tuple(mesh.shape) == (1, 1)
        x = torch.arange(24.0).reshape(4, 6)
        d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        with meshctx.use_mesh(mesh):
            assert meshctx.constrain(d, ("pod", "data"), "model") is d
            z = d + torch.ones(4, 6)
            assert torch.equal(z.full_tensor(), x + 1)
        sh = hs.make_param_shardings(mesh, {"embed": x}, hs.ShardingPlan())
        assert sh["embed"].spec == ("model", "data")
        assert hs.spec_tree(mesh, {"embed": x}, hs.ShardingPlan()) == \
            {"embed": ("model", "data")}
        assert sh["embed"].placements == (Replicate(), Replicate())
        t = hs.shard_tree({"embed": x}, sh)["embed"]
        assert torch.equal(t.to_local(), x)
        cache = {"seg0": ({"k": torch.zeros(2, 4, 8, 2, 4)},)}
        csh = hs.make_cache_shardings(mesh, cache, hs.ShardingPlan(),
                                      batch=4)
        assert csh["seg0"][0]["k"].spec == (None, "data", None, "model",
                                            None)
    finally:
        dist.destroy_process_group()


def test_size_one_mesh_dims_replicate():
    """``placements_on``: a mesh dim of size 1 never shards (as in JAX);
    the others keep the spec's placements."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.layout import placements_on
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(1, 2, 4))
    assert placements_on((("pod", "data"), "model"), mesh) == \
        (Replicate(), Shard(0), Shard(1))
    assert placements_on((None, "pod"), mesh) == (Replicate(),) * 3


def test_distribute_refuses_uneven_shards():
    """DTensor would chunk a dim that does not divide unevenly, JAX never
    does: ``distribute`` raises before any chunk is cut."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 4))
    with pytest.raises(LayoutError, match="not divisible"):
        hs.distribute(torch.zeros(6, 8), mesh, (Replicate(), Shard(0)))
    with pytest.raises(LayoutError, match="not divisible"):
        hs.distribute(torch.zeros(4, 8), mesh, (Shard(0), Shard(0)))


def test_plain_configs_are_dataclasses():
    """The port's ShardingPlan carries the reference's fields and
    defaults."""
    assert [f.name for f in dataclasses.fields(hs.ShardingPlan)] == \
        [f.name for f in dataclasses.fields(jhs.ShardingPlan)]
    assert dataclasses.asdict(hs.ShardingPlan()) == \
        dataclasses.asdict(jhs.ShardingPlan())
