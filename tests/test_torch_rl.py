"""The port's HyperRL against the reference's, on the CPU.

Float32 reduced configs, the same params (the reference's ``init_model``,
bridged; the cached per-arch models of ``tests/test_torch_serve.py``):

- the GRPO buffer: ``group_advantages`` and ``RolloutBuffer.batch`` equal
  to ``repro.rl.buffer``'s arrays exactly (the same numpy code);
- ``token_logprobs`` with a padded vocab and a temperature within 1e-5;
- ``grpo_loss`` and every gradient leaf within 1e-5 x max(1, max |grad|)
  (sums in another order over two layers), and one ``GRPOLearner.update``
  from the same params and batch, the params within AdamW's bound (a
  first step moves a weight by at most lr, whatever the gradient, so two
  updates whose gradients differ in rounding part by at most 2 lr), for
  qwen2-0.5b and for deepseek-v2-lite-16b under the ragged dispatch (the
  grouped matmul's backward), against ``repro.rl.learner`` with no mesh;
- a colocated two-iteration ``RLSession``: ``weights_version`` 1 then 2,
  the on-policy ratio ~1, and greedy probes after the publish identical to
  a fresh port ``Generator`` and to the reference ``RLSession``'s
  ``rollout_greedy`` on the same params;
- ``tests/test_rl.py``'s publication semantics (the version counter in
  flight, supersede, idle install) and seeded rollouts bit-reproducible
  across preemption, in the port; an in-flight rollout finishes on the
  weights it started with after the learner has updated;
- the batched sampler against ``_sample`` row by row (identical tokens,
  logprobs within 1e-6), a row's token independent of the other seats,
  and the counter-based draw's frequencies against the softmax;
- the refusals (roles, plans, meshes: ROADMAP.md item 8) and the launcher
  on an explicit CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.api import Supernode, plans  # noqa: E402
from repro.configs.base import RLConfig as JaxRLConfig  # noqa: E402
from repro.configs.base import ServeConfig as JaxServeConfig  # noqa: E402
from repro.rl import buffer as jax_buffer  # noqa: E402
from repro.rl import learner as jax_learner  # noqa: E402
from repro_torch.api.errors import PlanError  # noqa: E402
from repro_torch.configs.base import RLConfig, ServeConfig  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.rl import (GRPOLearner, RLSession, Rollout,  # noqa: E402
                            RolloutBuffer, RolloutEngine, group_advantages,
                            make_rl_step)
from repro_torch.rl import learner  # noqa: E402
from repro_torch.serve.engine import GenerateConfig, Generator  # noqa: E402
from repro_torch.serve.runtime import (ServeEngine, row_keys,  # noqa: E402
                                       sample_rows)
from repro_torch.serve.scheduler import Request, RequestState  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from test_torch_serve import _models  # noqa: E402

RL = dict(group_size=3, prompts_per_iter=2, max_new_tokens=6,
          temperature=1.0, lr=1e-3)
SERVE = dict(block_size=4, num_blocks=64, max_blocks_per_req=8, max_slots=4,
             prefill_chunk=8, enable_prefix_cache=False)


def small_serve(**kw):
    return ServeConfig(**dict(SERVE, **kw))


def greedy_baseline(cfg, params, prompt, max_new):
    """A fresh port Generator: the parity oracle of published weights."""
    gen = Generator(cfg, params, max_len=64, device="cpu")
    out = gen.generate(torch.tensor([prompt]),
                       GenerateConfig(max_new_tokens=max_new))
    return out[0, len(prompt):].tolist()


def _to_jax(tree, like):
    """A port param tree as the reference's pytree ``like`` (the port
    flattens in JAX's order)."""
    leaves = [v.detach().numpy() for _, v in tree_flatten_with_path(tree)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like),
                                        [jnp.asarray(v) for v in leaves])


def _rollouts(rng, n_groups, group, vocab, P=(3, 7), N=(2, 9)):
    """Random finished rollouts with logprobs, rewards a group's own."""
    out = []
    for gid in range(n_groups):
        prompt = rng.integers(1, vocab, size=int(rng.integers(*P))).tolist()
        ros, rewards = [], []
        for _ in range(group):
            n = int(rng.integers(*N))
            ros.append(Rollout(
                prompt=list(prompt),
                tokens=rng.integers(1, vocab, size=n).tolist(),
                logprobs=(-np.log(vocab) + 0.3 * rng.standard_normal(n))
                .tolist(), group=gid))
            rewards.append(float(rng.integers(0, 4)))
        out.append((ros, rewards))
    return out


def _batch(cfg, seed):
    buf = RolloutBuffer()
    for ros, rewards in _rollouts(np.random.default_rng(seed), 2, 3,
                                  cfg.vocab_size):
        buf.add_group(ros, rewards)
    return buf.batch(pad_len_to=4)


# ---------------------------------------------------------------------------
# buffer and objective
# ---------------------------------------------------------------------------
def test_group_advantages_and_batch_equal_the_reference():
    rng = np.random.default_rng(0)
    for rewards in ([1.0, 2.0, 3.0], [2.0, 2.0, 2.0], [5.0], [0.5, -1.0],
                    rng.standard_normal(6).tolist()):
        assert group_advantages(rewards) == jax_buffer.group_advantages(
            rewards)
    groups = _rollouts(rng, 3, 4, 50)
    port, ref = RolloutBuffer(), jax_buffer.RolloutBuffer()
    for ros, rewards in groups:
        port.add_group(ros, rewards)
        ref.add_group([jax_buffer.Rollout(**dataclasses.asdict(r))
                       for r in ros], rewards)
    assert len(port) == len(ref) == 12
    for kw in ({}, dict(pad_len_to=16, pad_rows_to=5)):
        a, b = port.batch(**kw), ref.batch(**kw)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for buf, cls in ((port, Rollout), (ref, jax_buffer.Rollout)):
        buf.add(cls(prompt=[1], tokens=[2, 3], logprobs=[], group=9))
        with pytest.raises(ValueError, match="logprobs"):
            buf.batch()


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_token_logprobs_match_reference(temperature):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((2, 5, 512))).astype(np.float32)
    targets = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    got = learner.token_logprobs(torch.from_numpy(logits),
                                 torch.from_numpy(targets), 300,
                                 temperature=temperature)
    want = jax_learner.token_logprobs(jnp.asarray(logits),
                                      jnp.asarray(targets), 300,
                                      temperature=temperature)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 1e-5


@pytest.mark.parametrize("arch,dispatch", [("qwen2-0.5b", "gshard"),
                                           ("deepseek-v2-lite-16b",
                                            "ragged")])
def test_grpo_loss_grads_and_update_match_reference(arch, dispatch):
    """grpo_loss and its gradient leaf by leaf against jax.grad of the
    reference's, then one GRPOLearner.update on each side from the same
    params and batch (the reference's with no mesh)."""
    jcfg, cfg, jp, tp = _models(arch)
    batch = _batch(cfg, 1)
    rl_cfg = RLConfig(**RL)
    jrl = JaxRLConfig(**RL)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_learner.grpo_loss(p, b, jcfg, rl_cfg=jrl,
                                           moe_dispatch=dispatch),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (tl, tm), tg = steps.grad_of(
        lambda p: learner.grpo_loss(p, tb, cfg, rl_cfg=rl_cfg,
                                    moe_dispatch=dispatch), tp)
    assert abs(float(jl) - float(tl)) <= 1e-5
    for k in ("pg_loss", "aux", "ratio_mean", "clip_fraction", "logp_mean"):
        assert abs(float(jm[k]) - float(tm[k])) <= 1e-5, k
    assert 0 < float(tm["clip_fraction"]) < 1      # both branches taken
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    got = tree_flatten_with_path(tg)
    assert len(want) == len(got)
    for (_, w), (k, g) in zip(want, got):
        w = np.asarray(w)
        assert np.max(np.abs(g.numpy() - w)) <= \
            1e-5 * max(1.0, float(np.max(np.abs(w)))), k

    jlearn = jax_learner.GRPOLearner(jcfg, None, None, rl_cfg=jrl,
                                     params=jp, moe_dispatch=dispatch)
    tlearn = GRPOLearner(cfg, rl_cfg=rl_cfg, params=tp,
                         moe_dispatch=dispatch, device="cpu")
    jmet, tmet = jlearn.update(batch), tlearn.update(batch)
    assert abs(jmet["loss"] - tmet["loss"]) <= 1e-5
    assert abs(jmet["grad_norm"] - tmet["grad_norm"]) <= 1e-4 * max(
        1.0, jmet["grad_norm"])
    # AdamW's first step moves a weight by at most lr (plus its decay):
    # two steps from one state part by at most 2 lr and an f32 rounding
    bound = 2 * rl_cfg.lr + 2 * 2.0 ** -23 * max(
        float(np.max(np.abs(np.asarray(w)))) for w in jax.tree.leaves(jp))
    pj = jax.tree_util.tree_flatten_with_path(jlearn.params)[0]
    for (_, a), (k, b) in zip(pj, tree_flatten_with_path(tlearn.params)):
        assert np.max(np.abs(b.numpy() - np.asarray(a))) <= bound, k
    assert tlearn.updates == 1 and tlearn.dp_size() == 1
    assert tlearn.obs.compiled_keys("rl_step") == [tuple(
        tuple(v.shape) for _, v in sorted(batch.items()))]


# ---------------------------------------------------------------------------
# the colocated loop
# ---------------------------------------------------------------------------
def test_colocated_session_loop_and_greedy_parity():
    """Two iterations of rollout -> advantage -> update -> publish: the
    version ticks once an iteration, the on-policy ratio is ~1 (the actor's
    logprobs from the paged steps, the learner's from the train forward),
    the policy moves; greedy probes through the actor then equal a fresh
    port Generator on the learner's params and the reference RLSession's
    rollout_greedy on the same params."""
    jcfg, cfg, jp, tp = _models("qwen2-0.5b")
    rl = RLSession(cfg, rl_cfg=RLConfig(**RL), serve_cfg=small_serve(),
                   params=tp, device="cpu")
    rl.obs.trace.enable()
    before = tree_flatten_with_path(tp)[0][1].clone()
    prompts = [list(range(1, 7)), list(range(10, 18))]
    for it in range(2):
        m = rl.iterate(prompts, lambda p, t: float(len(set(t))))
        assert np.isfinite(m["loss"])
        assert m["weights_version"] == it + 1
        assert m["ratio_mean"] == pytest.approx(1.0, abs=1e-3)
        assert m["rollout_tokens"] == 2 * 3 * 6
    after = tree_flatten_with_path(rl.learner.params)[0][1]
    assert not torch.equal(before, after)
    assert rl.utilization_report() == {}
    st = rl.stats()
    assert st["weights_version"] == 2 and st["learner_updates"] == 2
    mt = rl.obs.metrics
    assert mt.counter("rl.updates").value == 2
    assert mt.counter("rl.publishes").value == 2
    assert mt.gauge("rl.weights_version").value == 2
    assert mt.histogram("rl.stage_to_install_s").count == 2
    names = {e["name"] for e in rl.obs.trace.events()}
    assert {"rl.rollout", "rl.evaluate", "rl.update", "rl.publish",
            "publish.reshard", "publish.stage",
            "publish.install"} <= names
    assert {"rl_step", "sampler"} <= set(rl.obs.compiled_keys())
    assert rl.obs.compiled_keys("sampler") == [(SERVE["max_slots"],)]

    probe = list(range(1, 9))
    got = rl.rollout_greedy(probe, 5)
    assert got == greedy_baseline(cfg, rl.learner.params, probe, 5)
    jrl = Supernode().rl(jcfg, plan=plans.rl_colocate(
        serve=JaxServeConfig(**SERVE), rl=JaxRLConfig(**RL)),
        params=_to_jax(rl.learner.params, jp))
    assert jrl.rollout_greedy(probe, 5) == got


# ---------------------------------------------------------------------------
# weight publication semantics (tests/test_rl.py's, in the port)
# ---------------------------------------------------------------------------
def _qwen():
    _, cfg, _, tp = _models("qwen2-0.5b")
    return cfg, tp


def test_publish_version_counter_in_flight():
    cfg, params_old = _qwen()
    params_new = M.init_model(cfg, torch.Generator().manual_seed(7))
    prompt = list(range(1, 9))
    want_old = greedy_baseline(cfg, params_old, prompt, 8)
    want_new = greedy_baseline(cfg, params_new, prompt, 8)
    assert want_old != want_new, "weak test: policies agree on this prompt"

    actor = RolloutEngine(cfg, params_old, serve_cfg=small_serve(),
                          device="cpu")
    rid = actor.submit_probe(prompt, 8)
    for _ in range(3):                             # request mid-generation
        actor.step()
    assert not actor.request(rid).done
    v = actor.publish(params_new)
    assert v == 1 and actor.version == 0, "installed while in flight"
    assert actor.publisher.pending
    actor.drain()
    assert actor.request(rid).generated == want_old, \
        "in-flight request saw the new weights"
    assert actor.version == 1 and not actor.publisher.pending

    rid2 = actor.submit_probe(prompt, 8)
    actor.drain()
    assert actor.request(rid2).generated == want_new


def test_publish_supersede_and_idle_install():
    cfg, params = _qwen()
    p1 = M.init_model(cfg, torch.Generator().manual_seed(1))
    p2 = M.init_model(cfg, torch.Generator().manual_seed(2))
    actor = RolloutEngine(cfg, params, serve_cfg=small_serve(), device="cpu")
    assert actor.publish(p1) == 1 and actor.version == 1   # idle: immediate

    prompt = list(range(3, 11))
    rid = actor.submit_probe(prompt, 6)
    for _ in range(2):
        actor.step()
    assert not actor.request(rid).done
    actor.publish(p2)
    actor.publish(params)                          # supersedes p2
    assert actor.version == 1 and actor.publisher.staged_version == 3
    actor.drain()
    assert actor.version == 3
    rid2 = actor.submit_probe(prompt, 6)
    actor.drain()
    assert actor.request(rid2).generated == greedy_baseline(
        cfg, params, prompt, 6)


def test_in_flight_rollout_finishes_on_the_weights_it_started_with():
    """The actor serves the learner's own tensors (one device, no copy):
    a rollout in flight while the learner updates and publishes finishes
    on the old weights, since the update writes no tensor in place; the
    next rollout runs on the new ones."""
    cfg, tp = _qwen()
    learn = GRPOLearner(cfg, rl_cfg=RLConfig(**RL), params=tp, device="cpu")
    actor = RolloutEngine(cfg, learn.params, serve_cfg=small_serve(),
                          device="cpu")
    old = [(k, v.clone()) for k, v in tree_flatten_with_path(tp)]
    prompt = list(range(2, 10))
    want_old = greedy_baseline(cfg, learn.params, prompt, 8)
    rid = actor.submit_probe(prompt, 8)
    for _ in range(3):
        actor.step()
    learn.update(_batch(cfg, 2))
    assert actor.publish(learn.params) == 1 and actor.version == 0
    actor.drain()
    assert actor.request(rid).generated == want_old
    for (k, a), (_, b) in zip(old, tree_flatten_with_path(tp)):
        assert torch.equal(a, b), k                # nothing written in place
    assert actor.version == 1
    rid2 = actor.submit_probe(prompt, 8)
    actor.drain()
    assert actor.request(rid2).generated == greedy_baseline(
        cfg, learn.params, prompt, 8)


def _stochastic_group(cfg, params, scfg, seeds):
    actor = RolloutEngine(cfg, params, serve_cfg=scfg, device="cpu",
                          rl_cfg=RLConfig(group_size=len(seeds),
                                          max_new_tokens=8, temperature=1.0))
    g = actor.submit_group(list(range(1, 5)), seeds=seeds)
    actor.drain()
    ros = actor.collect(g)
    return ([ro.tokens for ro in ros], [ro.logprobs for ro in ros],
            actor.engine.stats())


def test_seeded_rollouts_bit_reproducible_across_preemption():
    cfg, params = _qwen()
    seeds = [11, 12]
    ample = small_serve()
    tight = small_serve(block_size=2, num_blocks=9, max_blocks_per_req=6,
                        max_slots=2, prefill_chunk=4)
    toks_a, lps_a, _ = _stochastic_group(cfg, params, ample, seeds)
    toks_b, lps_b, st = _stochastic_group(cfg, params, tight, seeds)
    assert st["preemptions"] >= 1, "tight pool never preempted; weak test"
    assert toks_a == toks_b
    for a, b in zip(lps_a, lps_b):
        assert np.allclose(a, b, atol=1e-5)
    assert toks_a[0] != toks_a[1]                  # distinct seeds explore
    assert _stochastic_group(cfg, params, ample, seeds)[:2] == (toks_a, lps_a)
    assert _stochastic_group(cfg, params, tight, seeds)[:2] == (toks_b, lps_b)


# ---------------------------------------------------------------------------
# the batched sampler
# ---------------------------------------------------------------------------
def test_batched_sampler_matches_single_rows():
    """_sample_batch (one computation over every seat) against _sample on
    each row: the same tokens, logprobs within 1e-6; a row's token does
    not depend on the other seats' logits, seeds or occupancy."""
    cfg, tp = _qwen()
    eng = ServeEngine(cfg, tp, serve_cfg=small_serve(), device="cpu")
    B, V = eng.scfg.max_slots, cfg.padded_vocab
    rng = np.random.default_rng(4)

    def req(slot, seed, n, temp):
        return Request(rid=slot, prompt=[1], max_new_tokens=9,
                       temperature=temp, seed=seed, capture_logprobs=True,
                       generated=list(range(n)), slot=slot,
                       state=RequestState.RUNNING)

    for trial in range(4):
        logits = torch.from_numpy(
            (2 * rng.standard_normal((B, V))).astype(np.float32))
        runners = [req(s, int(rng.integers(0, 2 ** 31)),
                       int(rng.integers(0, 9)), float(rng.uniform(0.5, 1.5)))
                   for s in range(B) if s != trial % B]
        picks = eng._sample_batch(runners, logits)
        for r in runners:
            lone = req(r.slot, r.seed, len(r.generated), r.temperature)
            assert eng._sample(logits[r.slot], lone) == picks[r.slot]
            assert abs(lone.logprobs[0] - r.logprobs[0]) <= 1e-6
        # the first runner alone, the other seats' logits redrawn
        r0 = runners[0]
        other = logits.clone()
        other[torch.arange(B) != r0.slot] = torch.from_numpy(
            rng.standard_normal((B - 1, V)).astype(np.float32))
        alone = req(r0.slot, r0.seed, len(r0.generated), r0.temperature)
        assert eng._sample_batch([alone], other)[r0.slot] == picks[r0.slot]


def test_counter_draw_follows_the_softmax():
    """Over 40000 (seed, position) keys the Gumbel-max draw's token
    frequencies match softmax(logits / T) within 4 standard errors."""
    V, n = 6, 40000
    logits = torch.tensor([[1.0, 0.0, -1.0, 2.0, 0.5, -3.0]]).expand(n, V)
    vh = torch.arange(V, dtype=torch.int64) * 7919 + 13
    keys = torch.from_numpy(row_keys(np.arange(n) // 50, np.arange(n) % 50))
    temps = torch.full((n,), 0.8)
    tok, lp = sample_rows(logits, keys, temps, vh)
    p = torch.softmax(logits[0] / 0.8, -1).numpy()
    freq = np.bincount(tok.numpy(), minlength=V) / n
    assert np.all(np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / n))
    assert torch.allclose(lp, torch.log(torch.from_numpy(p))[tok])


# ---------------------------------------------------------------------------
# refusals and the launcher
# ---------------------------------------------------------------------------
def test_roles_plans_and_meshes_are_refused():
    """What one process still refuses: roles that need more ranks than
    its world has (``TopologyError``, the reference's rule), roles other
    than exactly actor and learner, a plan that is no plan (the
    reference's ``PlanError`` from ``HyperPlan.coerce``), a mesh that is
    not a ``DeviceMesh``, and RL legs GRPO cannot learn from.  Roles and meshes themselves run in
    ``tests/test_torch_mesh_mpmd.py``."""
    from repro_torch.api.errors import TopologyError
    cfg, tp = _qwen()
    with pytest.raises(TopologyError, match="need more devices"):
        RLSession(cfg, params=tp, device="cpu",
                  roles=(("actor", 1), ("learner", 1)))
    with pytest.raises(PlanError, match="exactly"):
        RLSession(cfg, params=tp, device="cpu",
                  roles={"actor": 1, "critic": 1})
    with pytest.raises(PlanError, match="cannot coerce object into a "
                       "HyperPlan"):
        RLSession(cfg, params=tp, device="cpu", plan=object())
    for ctor in (RLSession, GRPOLearner):
        with pytest.raises(PlanError, match="DeviceMesh"):
            ctor(cfg, params=tp, device="cpu", mesh=object())
    with pytest.raises(PlanError, match="cannot coerce object into a "
                       "HyperPlan"):
        make_rl_step(cfg, None, rl_cfg=RLConfig(), plan=object())
    for bad in (dict(group_size=1), dict(temperature=0.0),
                dict(max_new_tokens=0)):
        with pytest.raises(PlanError):
            RLSession(cfg, rl_cfg=RLConfig(**bad), params=tp, device="cpu")


def test_launcher_runs_on_an_explicit_cpu(capsys, monkeypatch):
    from repro_torch.launch import rl as launcher
    launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                   "--iters", "2", "--prompts", "1", "--group-size", "2",
                   "--max-new", "4"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("iter 0: loss=") and out[0].endswith(" v1")
    assert out[1].startswith("iter 1: loss=") and out[1].endswith(" v2")
    assert out[-1] == "done: 16 rollout tokens, 2 updates, weights v2"
    launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--explain"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("HyperPlan resolution: model=qwen2-0.5b "
                             "plan=rl_colocate")
    with pytest.raises(SystemExit, match=">= 2 ranks"):
        launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--plan",
                       "rl_disagg"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--iters", "1"])
