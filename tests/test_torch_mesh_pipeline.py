"""The port's 1F1B pipeline trainer on CPU ranks: one process a stage,
stage meshes, and hand-offs that cannot deadlock.

One process set of four ranks under gloo (``torch_mesh_pipeline_worker.py``,
a fresh interpreter each, single-threaded, joined through a ``FileStore``
file in the test's temporary directory).  Params are the port's
``init_model`` at seed 0 in f32 on a 4-layer reduced qwen2-0.5b (tied
embeddings).  The JAX side is not run here: ``test_torch_pipeline.py``
holds the colocated port against it.

- one rank a stage (S = 4, M = 2, two steps): every rank's history and
  merged params bit for bit those of the colocated run of the same config,
  which rank 0 computes after the pipelined one in the same process with
  the same thread settings (the same kernels on the same tensors, the
  hand-offs exact byte copies, the norm's partial sums added in stage
  order);
- the ``pipeline_fsdp`` plan at S = 2 with ``stage_mesh=(2, 1)``: each
  stage's params sharded over its data axis and the micro-batch's rows
  too, within 1e-5 relative of the colocated run (the sharded sums round
  otherwise), params within AdamW's bound; a micro-batch that the stage
  data axis does not divide is refused with the reference's text;
- hand-offs of 32 MB tensors between two groups of two ranks in the S = 2,
  M = 4 1F1B order, where a stage sends an activation while its neighbour
  sends a cotangent the other way: they finish, every byte received.
  Blocking sends of that size would wait on each other for ever, and the
  process group's timeout would fail the ranks.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.optim import adamw as opt  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mesh_pipeline_worker.py")
WORLD = 4
STEPS = 2
TIMEOUT_S = 60          # the process group's bound on a receive
SPEC = dict(layers=4, seq=32, batch=4, micro=2, steps=STEPS,
            handoff_bytes=32 << 20, timeout=TIMEOUT_S,
            cases={"stages": dict(stages=4, stage_mesh=[]),
                   "fsdp": dict(stages=2, stage_mesh=[2, 1])})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_pipeline")
    spec = dict(SPEC, store=str(out / "store"), out=str(out))
    (out / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(out / "spec.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    bad = [i for i, p in enumerate(procs) if p.returncode]
    assert not bad, "\n".join(f"rank {i}:\n{logs[i][-3000:]}" for i in bad)
    reports = [json.loads((out / f"report{r}.json").read_text())
               for r in range(WORLD)]
    params = {name: [dict(np.load(out / f"{name}{r}.npz"))
                     for r in range(WORLD)] for name in ("stages", "fsdp")}
    colocated = {name: dict(np.load(out / f"{name}_colocated.npz"))
                 for name in ("stages", "fsdp")}
    return reports, params, colocated


def _bound(ref) -> float:
    """AdamW's bound on two runs whose gradients differ only in rounding
    (``test_torch_pipeline.params_bound``)."""
    acfg = opt.AdamWConfig(total_steps=STEPS)
    b1, b2 = acfg.b1, acfg.b2
    total = 0.0
    for t in range(1, STEPS + 1):
        lr = float(opt.schedule(acfg, torch.tensor(t, dtype=torch.int32)))
        total += 2 * lr * ((1 - b1) / (1 - b1 ** t)
                           * sum((b1 * b1 / b2) ** j for j in range(t)) ** 0.5
                           * ((1 - b2 ** t) / (1 - b2)) ** 0.5)
    big = max(float(np.abs(v).max()) for v in ref.values())
    return total + 2 * STEPS * big * 2.0 ** -23


def test_one_rank_a_stage_is_the_colocated_run(runs):
    """S = 4 on four ranks: every rank's history (loss, grad norm, lr, ...)
    and merged params equal, bit for bit, the colocated run's; the
    counters are the schedule's (24 bubble slots, 12 hand-offs, 2 micro-
    batches and one tied-embedding sync a step) on every rank."""
    reports, params, colocated = runs
    want = reports[0]["stages_colocated"]
    for rank, rep in enumerate(reports):
        got = rep["stages"]
        assert [{k: v for k, v in h.items() if k != "wall_s"}
                for h in got["history"]] == \
            [{k: v for k, v in h.items() if k != "wall_s"}
             for h in want["history"]], rank
        assert got["counters"] == want["counters"] == {
            "bubble_steps": STEPS * 24, "handoffs": STEPS * 12,
            "microbatches": STEPS * 2, "tied_embed_syncs": STEPS}
        assert sorted(params["stages"][rank]) == sorted(colocated["stages"])
        for k, v in colocated["stages"].items():
            assert np.array_equal(params["stages"][rank][k], v), (rank, k)


def test_pipeline_fsdp_on_stage_meshes(runs):
    """S = 2 with ``stage_mesh=(2, 1)`` under fsdp_tp: ranks (0, 1) run
    stage 0 and (2, 3) stage 1, each a (2, 1) mesh; loss, grad norm and lr
    within 1e-5 relative of the colocated run at every step, the same on
    every rank; every merged param within AdamW's bound, the same on every
    rank."""
    reports, params, colocated = runs
    want = reports[0]["fsdp_colocated"]["history"]
    for rank, rep in enumerate(reports):
        got = rep["fsdp"]["history"]
        assert got == [dict(h, wall_s=g["wall_s"]) for h, g in
                       zip(reports[0]["fsdp"]["history"], got)]
        for a, b in zip(got, want):
            for k in ("loss", "ce", "grad_norm", "lr"):
                assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), \
                    (rank, k)
    ref = colocated["fsdp"]
    bound = _bound(ref)
    for rank in range(WORLD):
        for k, v in ref.items():
            assert np.abs(params["fsdp"][rank][k] - v).max() <= bound, k
            assert np.array_equal(params["fsdp"][rank][k],
                                  params["fsdp"][0][k])
    for rep in reports:
        assert rep["refusal"]["groups"] == [[0, 1], [2, 3]]
        assert rep["refusal"]["meshes"] == [[2, 1], [2, 1]]


def test_micro_batch_the_stage_data_axis_does_not_divide_is_refused(runs):
    """Four micro-batches of a 4-row batch on stages whose data axis is 2:
    the reference's PipelinePlanError text on every rank, before any
    work."""
    for rep in runs[0]:
        assert rep["refusal"]["error"] == (
            "micro-batch size 1 (global_batch=4 / micro_batches=4) does not "
            "divide the stage data axis (2); fix micro_batches or "
            "stage_mesh")


def test_handoffs_of_32_mb_in_1f1b_order_finish(runs):
    """Eight hand-offs of 32 MB each way between two groups of two ranks
    (the source group's first rank sends to both destination ranks): every
    rank finished well inside the process group's timeout and received
    exactly what was sent."""
    for rank, rep in enumerate(runs[0]):
        got = rep["handoff"]
        assert got["ok"] and got["stage"] == rank // 2
        assert got["seconds"] < TIMEOUT_S / 2
