"""Rollout buffer: completed samples -> one padded GRPO learner batch.

A copy of the reference's ``repro.rl.buffer`` (numpy only), with the same
layout and padding, so both packages' learners see the same arrays.

Group-relative advantage estimation (GRPO): within each prompt's group of
``group_size`` samples the advantage is the reward's z-score against its
*siblings* — no value network, the group is the baseline:

    A_i = (r_i - mean(r_group)) / (std(r_group) + adv_eps)

``batch()`` packs everything into fixed numpy arrays for the update
step: ``inputs``/``targets`` are the usual shift-by-one over
``prompt + generated``; ``mask`` selects *response* target positions only
(the policy is never penalised for the prompt it was given); the
advantage broadcasts over the sample's response tokens; and
``behaviour_logp`` carries the actor-side sampled-token logprobs captured
at rollout time (the denominator of the PPO-style ratio).  Sequences pad
to the longest sample (optionally rounded up so step shapes repeat across
iterations) and rows pad to a divisibility multiple with zero-mask /
zero-advantage dummies so data-parallel learner meshes always split the
batch evenly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass
class Rollout:
    """One finished sample: what the actor generated and under what odds."""
    prompt: List[int]
    tokens: List[int]                  # generated (response) tokens
    logprobs: List[float]              # behaviour logprob per response token
    reward: float = 0.0
    group: int = 0                     # GRPO sibling-group id
    seed: int = 0                      # PRNG seed (replays bit-identically)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.tokens)


def group_advantages(rewards: Sequence[float], *,
                     adv_eps: float = 1e-6) -> List[float]:
    """Z-score a group's rewards against the group itself (the GRPO
    baseline).  A degenerate group (all rewards equal) gets all-zero
    advantages — no gradient, which is the correct signal."""
    r = np.asarray(rewards, np.float64)
    if len(r) < 2:
        return [0.0] * len(r)
    centred = r - r.mean()
    std = r.std()
    if std < adv_eps:
        return [0.0] * len(r)
    return (centred / (std + adv_eps)).tolist()


class RolloutBuffer:
    def __init__(self, *, adv_eps: float = 1e-6):
        self.adv_eps = adv_eps
        self._groups: Dict[int, List[Rollout]] = {}

    def add(self, rollout: Rollout) -> None:
        self._groups.setdefault(rollout.group, []).append(rollout)

    def add_group(self, rollouts: Sequence[Rollout],
                  rewards: Sequence[float]) -> None:
        if len(rollouts) != len(rewards):
            raise ValueError(f"{len(rollouts)} rollouts vs "
                             f"{len(rewards)} rewards")
        for ro, r in zip(rollouts, rewards):
            ro.reward = float(r)
            self.add(ro)

    def __len__(self) -> int:
        return sum(len(g) for g in self._groups.values())

    def clear(self) -> None:
        self._groups.clear()

    # ------------------------------------------------------------------
    def advantages(self) -> Dict[int, List[float]]:
        """Per-group group-relative advantages, keyed by group id."""
        return {gid: group_advantages([ro.reward for ro in g],
                                      adv_eps=self.adv_eps)
                for gid, g in self._groups.items()}

    def batch(self, *, pad_len_to: int = 1,
              pad_rows_to: int = 1) -> Dict[str, np.ndarray]:
        """One learner batch over every buffered rollout.

        ``pad_len_to`` rounds the (shift-by-one) sequence length up so the
        update step sees a new shape only when rollouts genuinely outgrow
        the previous one; ``pad_rows_to`` rounds the row count up with
        zero-mask dummies so dp-sharded learner meshes divide evenly.
        """
        if not self._groups:
            raise ValueError("empty buffer: nothing to batch")
        advs = self.advantages()
        rows = [(ro, advs[gid][i]) for gid, g in self._groups.items()
                for i, ro in enumerate(g)]
        S = max(ro.total_len for ro, _ in rows) - 1           # shift-by-one
        S = -(-S // pad_len_to) * pad_len_to
        B = -(-len(rows) // pad_rows_to) * pad_rows_to
        inputs = np.zeros((B, S), np.int32)
        targets = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), np.float32)
        blogp = np.zeros((B, S), np.float32)
        adv = np.zeros((B,), np.float32)
        for b, (ro, a) in enumerate(rows):
            if len(ro.logprobs) != len(ro.tokens):
                raise ValueError(
                    f"rollout in group {ro.group} has {len(ro.logprobs)} "
                    f"logprobs for {len(ro.tokens)} tokens; submit groups "
                    "with capture_logprobs=True")
            seq = np.asarray(ro.prompt + ro.tokens, np.int32)
            P, n = len(ro.prompt), len(seq) - 1
            inputs[b, :n] = seq[:-1]
            targets[b, :n] = seq[1:]
            mask[b, P - 1:n] = 1.0        # response targets only
            blogp[b, P - 1:n] = ro.logprobs
            adv[b] = a
        return {"inputs": inputs, "targets": targets, "mask": mask,
                "behaviour_logp": blogp, "advantages": adv}
