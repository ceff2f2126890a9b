"""HyperMPMD's core in one process: ``repro_torch.core.mpmd`` against
``repro.core.mpmd``.

- :func:`groups_from_mapping` refuses a mapping that needs more ranks than
  the world has, with the reference's ``ValueError``; the launchers'
  :func:`~repro_torch.launch.mesh.auto_roles` balances and refuses as the
  reference's ``Supernode._role_groups`` does;
- the analytic pipeline functions equal the reference's on a grid,
  exactly;
- :class:`MPMDScheduler` with one group of this one process: the task
  counter, the bubble counter and histogram, a span a task on the group's
  track and the utilization report;
- :func:`transfer` between two groups holding this one rank copies
  locally, exactly, into fresh storage;
- disaggregated serving refuses mamba2-370m and recurrentgemma-2b (3
  layers, window 16) with the reference's ``ServePlanError`` text, before
  any group is used (stub groups, as ``tests/test_hyperserve.py:567-584``
  uses them), and an engine given one group of the two with the
  reference's ``ValueError`` (and one given a mesh beside both groups).
"""
import dataclasses
import itertools
import time

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import mpmd as jax_mpmd  # noqa: E402
from repro.models import mixers as jax_mixers  # noqa: E402
from repro_torch.api.errors import ServePlanError, TopologyError  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import mpmd  # noqa: E402
from repro_torch.launch.mesh import auto_roles  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.api import HyperServe  # noqa: E402

HYBRID = {"num_layers": 3, "sliding_window": 16}


def test_groups_from_mapping_refuses_too_many_ranks():
    with pytest.raises(ValueError, match="mapping needs 3 devices, have 1"):
        mpmd.groups_from_mapping({"prefill": 2, "decode": 1})
    with pytest.raises(ValueError, match="mapping needs 2 devices, have 1"):
        mpmd.groups_from_mapping({"actor": 1, "learner": 1})
    with pytest.raises(ValueError) as port:
        mpmd.serving_groups(1, 1)
    with pytest.raises(ValueError) as ref:
        jax_mpmd.serving_groups(1, 1, devices=[object()])
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_auto_roles_balance_as_the_reference(n):
    """Counts of 0 share the ranks left over, the first roles taking the
    remainder: what the reference's ``_role_groups`` hands
    ``groups_from_mapping``."""
    got = auto_roles((("prefill", 0), ("decode", 0)), n)
    assert got == {"prefill": n - n // 2, "decode": n // 2}
    assert auto_roles({"actor": 1, "learner": 0}, n) == {
        "actor": 1, "learner": n - 1}
    with pytest.raises(TopologyError, match="need more devices"):
        auto_roles({"actor": n, "learner": 0}, n)


def test_analytic_functions_equal_the_reference():
    grid = [[1.0], [2.0, 1.0], [0.5, 0.5, 0.5], [3.0, 1.0, 2.0, 0.25],
            [1e-3, 7.0]]
    for times, micro in itertools.product(grid, [1, 2, 3, 8, 64]):
        assert mpmd.spmd_step_time(times) == jax_mpmd.spmd_step_time(times)
        assert mpmd.mpmd_step_time(times, micro) == \
            jax_mpmd.mpmd_step_time(times, micro)
        assert mpmd.pipeline_bubble_fraction(times, micro) == \
            jax_mpmd.pipeline_bubble_fraction(times, micro)
    for stages, micro in itertools.product(range(1, 9), [1, 4, 16]):
        assert mpmd.pipeline_bubble_steps(stages, micro) == \
            jax_mpmd.pipeline_bubble_steps(stages, micro)


def test_scheduler_counts_tasks_bubbles_and_spans():
    solo = mpmd.ProcessGroup("solo", (0,))
    sched = mpmd.MPMDScheduler({"solo": solo})
    sched.obs.trace.enable()

    def work(x):
        return x + 1
    a = sched.submit("solo", work, 1)
    assert sched.wait(a) == [2]
    time.sleep(0.01)
    b = sched.submit("solo", work, 2)
    assert sched.wait(b) == [3]
    m = sched.obs.metrics
    assert m.counter("mpmd.tasks.solo").value == 2
    gap = m.counter("mpmd.bubble_s.solo").value
    assert gap >= 0.01 and gap == pytest.approx(b.t_submit - a.t_done)
    assert m.histogram("mpmd.bubble_s").count == 1
    spans = [e for e in sched.obs.trace.events() if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["work", "work"]
    assert {e["args"]["group"] for e in spans} == {"solo"}
    busy = sched.utilization_report()
    assert set(busy) == {"solo"}
    assert busy["solo"] == pytest.approx(
        (a.t_done - a.t_submit) + (b.t_done - b.t_submit))


def test_transfer_within_one_rank_copies_exactly():
    """A rank in both groups copies its leaves locally: equal values,
    fresh storage, the tree's shape kept (a dict of tuples)."""
    g = torch.Generator().manual_seed(0)
    tree = {"seg0": ({"k": torch.randn(2, 3, generator=g),
                      "v": torch.randn(4, generator=g).bfloat16()},)}
    src = mpmd.ProcessGroup("learner", (0,))
    dst = mpmd.ProcessGroup("actor", (0,))
    got = mpmd.transfer(tree, src, dst, device="cpu")
    for k in ("k", "v"):
        a, b = tree["seg0"][0][k], got["seg0"][0][k]
        assert torch.equal(a, b) and a.dtype == b.dtype
        assert a.data_ptr() != b.data_ptr()


class _G:
    """A stub group: the disaggregation guard fires before a group is
    used."""
    mesh = None

    def __init__(self, name):
        self.name = name


@pytest.mark.parametrize("arch,over", [("mamba2-370m", {}),
                                       ("recurrentgemma-2b", HYBRID)])
def test_disaggregation_refuses_slot_and_windowed_state(arch, over):
    """mamba2's SSD seats and recurrentgemma's RG-LRU seats and windowed
    pages are not pure paged: ``ServePlanError`` with the reference's
    text, word for word."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
    with pytest.raises(Exception) as ref:
        jax_mixers.check_disagg_supported(
            jcfg, jax_mixers.model_state_layout(jcfg))
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ServePlanError) as port:
        HyperServe(cfg, params, prefill_group=_G("prefill"),
                   decode_group=_G("decode"), device="cpu")
    assert str(port.value) == str(ref.value)
    assert type(ref.value).__name__ == "ServePlanError"
    assert "slot" in str(port.value)


def test_one_group_of_two_is_refused():
    """One group of the two is the reference's ``ValueError``; a mesh
    beside both groups is refused too (each group serves on its own)."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="BOTH prefill and decode"):
        HyperServe(cfg, params, prefill_group=_G("prefill"), device="cpu")
    with pytest.raises(ValueError, match="groups' meshes"):
        HyperServe(cfg, params, mesh=object(), prefill_group=_G("prefill"),
                   decode_group=_G("decode"), device="cpu")
