"""RolloutEngine: GRPO prompt fan-out over HyperServe continuous batching.

The port of ``repro.rl.rollout`` over the port's
:class:`~repro_torch.serve.runtime.ServeEngine`, on one device or
tensor-parallel on a serving mesh (``mesh=``, ``plan=`` a
``ShardingPlan`` with ``fsdp=None``; a session's actor group's mesh is one,
as ``RLSession`` places it).  Each prompt fans out into
``group_size`` stochastic samples — one serving request each, with its own
recorded seed (bit-reproducible: the draw depends on the seed and the
position alone, ``serve/runtime.sample_rows``) and sampled-token logprob
capture — and the continuous-batching scheduler multiplexes every sample
of every group through the paged pool: chunked prefill interleaves with
decode, finished samples free their seats for queued ones, stragglers
never barrier the batch.  The decode steps of a rollout sample every seat
at once on the device (``ServeEngine._sample_batch``).

Weight publication rides on :class:`repro_torch.rl.publish.WeightPublisher`:
``publish`` stages the learner's weights and the engine loop installs them
at the next idle boundary, so in-flight rollouts always finish on the
policy that started them (the version counter records installs).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import RLConfig
from repro_torch.rl.publish import WeightPublisher
from repro_torch.serve.runtime import ServeEngine
from repro_torch.serve.scheduler import Request, RequestState


def resolve_moe_dispatch(cfg, moe_dispatch: Optional[str]) -> str:
    """The reference's serving default (``repro.serve.engine``): the
    dropless per-token ragged dispatch for MoE configs, whose output does
    not depend on which other tokens are seated; callers may name one."""
    if moe_dispatch is not None:
        return moe_dispatch
    return "ragged" if getattr(cfg, "moe", None) is not None else "gshard"


@dataclasses.dataclass
class RolloutGroup:
    """One prompt's fan-out: ``group_size`` sibling samples (GRPO group)."""
    gid: int
    prompt: List[int]
    rids: List[int]
    seeds: List[int]
    version: int                  # weights version the group was issued under


class RolloutEngine:
    """The actor: a ServeEngine on ``device`` (the card unless the caller
    names another), on ``mesh`` if given (every rank of it submitting the
    same groups), its publisher, and the groups in flight.  The port's
    paged steps run an MoE FFN under the ragged dispatch only, so a MoE
    config asked to serve under another raises."""

    def __init__(self, cfg, params, *, serve_cfg=None, mesh=None, plan=None,
                 rl_cfg: Optional[RLConfig] = None, seed: int = 0,
                 moe_dispatch: Optional[str] = None, obs=None, device=None):
        md = resolve_moe_dispatch(cfg, moe_dispatch)
        if cfg.moe is not None and md != "ragged":
            raise ValueError(f"moe_dispatch={md!r}: the port's paged serving "
                             "steps run the MoE FFN under 'ragged' only")
        self.cfg = cfg
        self.rl_cfg = rl_cfg or RLConfig()
        self.engine = ServeEngine(cfg, params, serve_cfg=serve_cfg, seed=seed,
                                  obs=obs, device=device, mesh=mesh,
                                  plan=plan)
        self.obs = self.engine.obs
        self.publisher = WeightPublisher(self.engine)
        self.groups: Dict[int, RolloutGroup] = {}
        self._gid = itertools.count()

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------
    def submit_group(self, prompt: Sequence[int], *,
                     group_size: Optional[int] = None,
                     max_new_tokens: Optional[int] = None,
                     temperature: Optional[float] = None,
                     eos_id: Optional[int] = None,
                     seeds: Optional[Sequence[int]] = None,
                     capture_logprobs: bool = True) -> RolloutGroup:
        """Fan one prompt out into a GRPO group of stochastic samples.

        Every sample gets a distinct per-request seed (explicit ``seeds``
        or the engine's deterministic per-rid default), so the whole group
        replays bit-identically given the same submission order.
        """
        g = group_size if group_size is not None else self.rl_cfg.group_size
        mn = (max_new_tokens if max_new_tokens is not None
              else self.rl_cfg.max_new_tokens)
        t = temperature if temperature is not None else self.rl_cfg.temperature
        if seeds is not None and len(seeds) != g:
            raise ValueError(f"seeds has {len(seeds)} entries for a "
                             f"group of {g}")
        rids, used = [], []
        for i in range(g):
            req = self.engine.scheduler.submit(
                list(prompt), mn, temperature=t, eos_id=eos_id,
                seed=None if seeds is None else seeds[i],
                capture_logprobs=capture_logprobs)
            if req.state is RequestState.REJECTED:
                # a partial group is useless to GRPO: cancel the siblings
                # already queued so they don't burn decode slots orphaned
                for rid in rids:
                    self.engine.scheduler.cancel(rid)
                raise RuntimeError(
                    f"rollout sample {i} rejected (prompt_len="
                    f"{len(prompt)}, max_new={mn}): grow the pool/queue in "
                    "the ServeConfig")
            rids.append(req.rid)
            used.append(req.seed)
        group = RolloutGroup(gid=next(self._gid), prompt=list(prompt),
                             rids=rids, seeds=used,
                             version=self.publisher.staged_version)
        self.groups[group.gid] = group
        return group

    def submit_probe(self, prompt: Sequence[int], max_new_tokens: int, *,
                     eos_id: Optional[int] = None) -> int:
        """One greedy, logprob-free request (eval / parity probes)."""
        req = self.engine.scheduler.submit(list(prompt), max_new_tokens,
                                           temperature=0.0, eos_id=eos_id)
        if req.state is RequestState.REJECTED:
            raise RuntimeError("probe rejected by admission control")
        return req.rid

    # ------------------------------------------------------------------
    # the drive loop (single-controller, like everything here)
    # ------------------------------------------------------------------
    def step(self):
        """One engine iteration; installs pending weights when safe."""
        self.publisher.maybe_install()
        return self.engine.step()

    def drain(self, max_steps: int = 100_000) -> None:
        steps = 0
        while self.engine.scheduler.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"rollout drain stalled ({max_steps} steps)")
        self.publisher.maybe_install()

    # ------------------------------------------------------------------
    # results + weights
    # ------------------------------------------------------------------
    def request(self, rid: int) -> Request:
        return self.engine.scheduler.requests[rid]

    def collect(self, group: RolloutGroup):
        """The group's finished samples as :class:`repro_torch.rl.buffer.
        Rollout`s."""
        from repro_torch.rl.buffer import Rollout
        out = []
        for rid, seed in zip(group.rids, group.seeds):
            req = self.request(rid)
            if req.state is not RequestState.FINISHED:
                raise RuntimeError(f"rollout {rid} not finished "
                                   f"({req.state.value}); drain() first")
            out.append(Rollout(prompt=list(group.prompt),
                               tokens=list(req.generated),
                               logprobs=list(req.logprobs),
                               group=group.gid, seed=seed))
        return out

    def release(self, group: RolloutGroup) -> None:
        """Drop a collected group's bookkeeping (long-loop memory bound:
        finished Request objects and their token/logprob lists would
        otherwise accumulate for the engine's lifetime)."""
        for rid in group.rids:
            self.engine.scheduler.requests.pop(rid, None)
        self.groups.pop(group.gid, None)

    def release_probe(self, rid: int) -> List[int]:
        """Pop a finished probe's tokens (and its bookkeeping)."""
        req = self.engine.scheduler.requests.pop(rid)
        return list(req.generated)

    def publish(self, params, *, wait: bool = False) -> int:
        """Stage new policy weights; see :class:`WeightPublisher`."""
        return self.publisher.publish(params, wait=wait)

    @property
    def version(self) -> int:
        return self.publisher.version

    def stats(self) -> Dict[str, float]:
        s = self.engine.stats()
        s.update({"weights_version": self.publisher.version,
                  "publish_pending": float(self.publisher.pending),
                  "rollout_groups": len(self.groups)})
        return s
