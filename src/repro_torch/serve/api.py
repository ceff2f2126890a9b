"""HyperServe front door: submit / stream / cancel / stats (PyTorch port).

The port of ``repro.serve.api``: a thin request/response surface over
:class:`~repro_torch.serve.runtime.ServeEngine`
for embedding the serving stack in-process (examples, benchmarks, tests —
a network listener would sit one level above this and own nothing more
than serialisation):

    serve = HyperServe(cfg, params)      # on the card; device="cpu" to opt out
    # or tensor-parallel: HyperServe(cfg, params, mesh=mesh), every rank
    # submitting the same requests (mesh: launch.mesh.make_host_mesh)
    rid = serve.submit([1, 2, 3], max_new_tokens=16)
    for tok in serve.stream(rid):        # drives the engine lazily
        ...
    serve.stats()

Disaggregated (``prefill_group=`` / ``decode_group=``, the role groups of
:func:`repro_torch.core.mpmd.serving_groups`): every rank of the world
builds ``HyperServe`` with the same arguments and calls ``submit``,
``cancel``, ``step_once``, ``join`` and ``stats`` in the same order.  The
decode group's ranks run the engine; the prefill group's ranks run a
:class:`~repro_torch.serve.runtime.PrefillWorker` that prefills what the
engine asks for while they wait for the call's result, which the decode
group's first rank sends them, so that each call returns the same value
on every rank.  ``stream`` and the per-request views run on the decode
group's ranks.

``submit`` applies admission control (a bounded queue; oversized or
unservable prompts are rejected with :class:`RequestRejected`).  The
engine advances only inside :meth:`step_once`, :meth:`stream`, and
:meth:`join` — there is no background thread, so callers control exactly
when device work happens (single-controller, like everything else here).

Rejection contract (shared with the HyperFabric front door): every
admission refusal anywhere in the serving stack raises
:class:`RequestRejected`, a *typed* error carrying

  - ``reason`` — ``"queue_full"`` (bounded queue at capacity; transient,
    retry after ``retry_after_s``), ``"over_quota"`` (the tenant's
    in-flight cap is reached; fabric-level only), or ``"unservable"``
    (the prompt/budget can never fit the pool — retrying is pointless);
  - ``tenant`` — the submitting tenant, when the front door is the
    multi-tenant fabric (None for bare engine submits);
  - ``retry_after_s`` — a backpressure hint for retryable reasons
    (None when retrying cannot help).

so a client can branch on the *category* without parsing messages.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

from repro_torch.core import mpmd
from repro_torch.obs import Observability
from repro_torch.serve.runtime import PrefillWorker, ServeEngine, disagg_role
from repro_torch.serve.scheduler import RequestState


class RequestRejected(RuntimeError):
    """Admission control refused the request (typed front-door rejection).

    Attributes: ``tenant`` (str | None), ``reason`` ("queue_full" |
    "over_quota" | "unservable"), ``retry_after_s`` (float | None —
    set only when retrying can help).  See the module docstring for the
    full contract.
    """

    def __init__(self, message: str, *, tenant: Optional[str] = None,
                 reason: str = "unservable",
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = retry_after_s


class HyperServe:
    def __init__(self, cfg, params, *, serve_cfg=None, mesh=None, plan=None,
                 seed: int = 0, obs: Optional[Observability] = None,
                 device=None,
                 prefill_group: Optional[mpmd.ProcessGroup] = None,
                 decode_group: Optional[mpmd.ProcessGroup] = None):
        role = disagg_role(cfg, prefill_group, decode_group, mesh)
        # on a prefill rank every call waits for the decode ranks' result
        self._follows = role == "prefill"
        if self._follows:
            self.engine = PrefillWorker(cfg, params, serve_cfg=serve_cfg,
                                        plan=plan, obs=obs, device=device,
                                        prefill_group=prefill_group,
                                        decode_group=decode_group)
        else:
            self.engine = ServeEngine(cfg, params, serve_cfg=serve_cfg,
                                      mesh=mesh, plan=plan, seed=seed,
                                      obs=obs, device=device,
                                      prefill_group=prefill_group,
                                      decode_group=decode_group)

    def obs(self) -> Observability:
        """The HyperTrace hub this server reports into."""
        return self.engine.obs

    def _call(self, fn):
        """``fn()`` on the decode ranks, the result (or the error) of the
        decode group's first rank sent to every other rank; on a prefill
        rank that result, after prefilling what the call asked for."""
        if self._follows:
            return self.engine.follow()
        eng = self.engine
        if eng.prefill_group is None:
            return fn()
        lead = eng.is_decode_leader
        others = [r for r in mpmd.union_ranks((eng.prefill_group,
                                               eng.decode_group))
                  if r != mpmd.my_rank()]
        try:
            out = fn()
        except Exception as e:
            if lead:
                for r in others:
                    mpmd.send_obj(("raise", RuntimeError(
                        f"the decode group raised {type(e).__name__}: "
                        f"{e}")), r)
            raise
        if lead:
            for r in others:
                mpmd.send_obj(("reply", out), r)
            return out
        kind, value = mpmd.recv_obj(eng.decode_group.leader)
        if kind == "raise":
            raise value
        return value

    def _decode_rank_only(self, what: str) -> None:
        if self._follows:
            raise RuntimeError(f"{what} runs on the decode group's ranks; "
                               "this rank is in the prefill group")

    # -- intake ------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               seed: Optional[int] = None, capture_logprobs: bool = False,
               arrival: Optional[float] = None) -> int:
        def admit():
            req = self.engine.scheduler.submit(
                list(prompt), max_new_tokens, temperature=temperature,
                eos_id=eos_id, seed=seed, capture_logprobs=capture_logprobs,
                arrival=arrival)
            return req.rid, req.reject_reason, req.state is \
                RequestState.REJECTED
        rid, why, rejected = self._call(admit)
        if rejected:
            raise RequestRejected(
                f"request rejected ({why}): "
                f"prompt_len={len(prompt)} max_new={max_new_tokens}",
                reason=why or "unservable",
                retry_after_s=(0.05 if why == "queue_full" else None))
        return rid

    def cancel(self, rid: int) -> bool:
        return self._call(lambda: self.engine.scheduler.cancel(rid))

    # -- progress ----------------------------------------------------------
    def step_once(self) -> List[tuple]:
        """Advance the engine one iteration; returns [(rid, token)]."""
        return self._call(lambda: self.engine.step())

    def stream(self, rid: int, max_steps: int = 100_000,
               final_meta: bool = False) -> Iterator:
        """Yield ``rid``'s tokens as they are generated, driving the engine.

        With ``final_meta=True`` one extra item follows the last token: the
        request's lifecycle record (:meth:`request_meta`) — the pinned
        ``seed`` and the exact queue-entry / first-token timings the
        scheduler stamped, so a client can log TTFT without ever seeing
        engine internals.
        """
        self._decode_rank_only("stream")
        req = self.engine.scheduler.requests[rid]
        emitted = 0
        steps = 0
        while True:
            while emitted < len(req.generated):
                yield req.generated[emitted]
                emitted += 1
            if req.done:
                if final_meta:
                    yield self.request_meta(rid)
                return
            self.engine.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"stream({rid}) stalled after {steps} steps")

    def request_meta(self, rid: int) -> Dict:
        """Per-request lifecycle record (exact scheduler-stamped timings)."""
        self._decode_rank_only("request_meta")
        req = self.engine.scheduler.requests[rid]
        return {
            "rid": req.rid,
            "seed": req.seed,
            "state": req.state.value,
            "n_tokens": len(req.generated),
            "finish_reason": (
                None if not req.done
                else "cancelled" if req.state is RequestState.CANCELLED
                else "eos" if (req.eos_id is not None and req.generated
                               and req.generated[-1] == req.eos_id)
                else "length"),
            "t_enqueue": req.t_enqueue,
            "queue_wait_s": (None if req.t_admit is None
                             else req.t_admit - req.t_enqueue),
            "ttft_s": (None if req.t_first_token is None
                       else req.t_first_token - req.t_enqueue),
            "latency_s": (None if req.t_finish is None
                          else req.t_finish - req.t_enqueue),
        }

    def join(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drain every queued/running request; returns {rid: tokens}."""
        return self._call(
            lambda: self.engine.run_until_complete(max_steps=max_steps))

    def result(self, rid: int) -> List[int]:
        self._decode_rank_only("result")
        req = self.engine.scheduler.requests[rid]
        return list(req.generated)

    def state(self, rid: int) -> str:
        self._decode_rank_only("state")
        return self.engine.scheduler.requests[rid].state.value

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """The engine's stats (the decode group's, on every rank)."""
        return self._call(lambda: self.engine.stats())

    def snapshot(self) -> Dict:
        """Read-only routing surface (see :meth:`ServeEngine.snapshot`;
        the decode group's, on every rank)."""
        return self._call(lambda: self.engine.snapshot())
