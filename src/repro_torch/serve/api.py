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

from repro_torch.obs import Observability
from repro_torch.serve.runtime import ServeEngine
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
                 device=None):
        self.engine = ServeEngine(cfg, params, serve_cfg=serve_cfg, mesh=mesh,
                                  plan=plan, seed=seed, obs=obs,
                                  device=device)

    def obs(self) -> Observability:
        """The HyperTrace hub this server reports into."""
        return self.engine.obs

    # -- intake ------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               seed: Optional[int] = None, capture_logprobs: bool = False,
               arrival: Optional[float] = None) -> int:
        req = self.engine.scheduler.submit(
            list(prompt), max_new_tokens, temperature=temperature,
            eos_id=eos_id, seed=seed, capture_logprobs=capture_logprobs,
            arrival=arrival)
        if req.state is RequestState.REJECTED:
            raise RequestRejected(
                f"request rejected ({req.reject_reason}): "
                f"prompt_len={len(prompt)} max_new={max_new_tokens}",
                reason=req.reject_reason or "unservable",
                retry_after_s=(0.05 if req.reject_reason == "queue_full"
                               else None))
        return req.rid

    def cancel(self, rid: int) -> bool:
        return self.engine.scheduler.cancel(rid)

    # -- progress ----------------------------------------------------------
    def step_once(self) -> List[tuple]:
        """Advance the engine one iteration; returns [(rid, token)]."""
        return self.engine.step()

    def stream(self, rid: int, max_steps: int = 100_000,
               final_meta: bool = False) -> Iterator:
        """Yield ``rid``'s tokens as they are generated, driving the engine.

        With ``final_meta=True`` one extra item follows the last token: the
        request's lifecycle record (:meth:`request_meta`) — the pinned
        ``seed`` and the exact queue-entry / first-token timings the
        scheduler stamped, so a client can log TTFT without ever seeing
        engine internals.
        """
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
        return self.engine.run_until_complete(max_steps=max_steps)

    def result(self, rid: int) -> List[int]:
        req = self.engine.scheduler.requests[rid]
        return list(req.generated)

    def state(self, rid: int) -> str:
        return self.engine.scheduler.requests[rid].state.value

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict[str, float]:
        return self.engine.stats()
