"""Plan resolution reports: every leaf, its spec, its memory tier, its rule.

The port of ``repro.api.explain``.  ``explain(plan, cfg, layout)`` runs
the full HyperShard derivation for a model config against a device matrix
— parameters, optimizer state and decode caches — without touching a
device (shapes come from meta tensors: the params from
:func:`repro_torch.mem.planner.param_shapes`, an init under
``FakeTensorMode``).  The result is a :class:`PlanReport` whose rows each
carry the derived spec (one entry per tensor dim, as the reference's
``PartitionSpec`` entries), the memory kind the leaf will live in, and
*which rule fired* (regex from the HyperShard rule table, or the
cache-derivation branch), plus notes for every divisibility fallback.

This is the paper's "formal derivation" made inspectable: the same report
that a human reads is what ``strict`` checks, so "a dim silently
replicated" is a reviewable line item (or a typed
:class:`~repro_torch.api.errors.IndivisibleError`), never a surprise at
run time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.api.errors import IndivisibleError
from repro_torch.api.plan import HyperPlan
from repro_torch.core import hypershard
from repro_torch.core.layout import Layout
from repro_torch.core.tree import tree_flatten_with_path

# device matrix used when a session has no mesh (single device): axis sizes
# are all 1 so nothing actually shards, but the report still shows where
# every leaf WOULD bind on a real matrix.
SINGLE_DEVICE_LAYOUT = Layout((1, 1), ("data", "model"))


@dataclasses.dataclass(frozen=True)
class LeafReport:
    kind: str                  # "param" | "opt" | "cache" | "state" | ...
    path: str
    shape: Tuple[int, ...]
    spec: object               # spec tuple, or a descriptive string
    memory: str                # "device" | "host" | serving-state kind
    #                            ("paged" | "slot" | "windowed(w=N)")
    rule: str                  # rule regex / cache branch that fired
    notes: Tuple[str, ...]     # divisibility fallbacks etc.

    @property
    def fell_back(self) -> bool:
        return bool(self.notes)


@dataclasses.dataclass(frozen=True)
class PlanReport:
    plan: HyperPlan
    model: str
    layout: Layout
    leaves: Tuple[LeafReport, ...]

    def select(self, kind: str) -> Tuple[LeafReport, ...]:
        return tuple(l for l in self.leaves if l.kind == kind)

    @property
    def params(self):
        return self.select("param")

    @property
    def caches(self):
        return self.select("cache")

    @property
    def opt(self):
        return self.select("opt")

    @property
    def serve_state(self):
        """Serving-state rows (paged pools + per-slot dense leaves)."""
        return self.select("state")

    @property
    def kernels(self):
        """Kernel-lowering rows: which attention path (fused kernel vs
        composed gather+dense) each paged sub-layer's decode / prefill
        hook lowers to under the plan's ``kernels`` toggle."""
        return self.select("kernel")

    @property
    def mem(self):
        """HyperMem residency rows (``offload_policy="graph"``): planned
        tier per parameter leaf + the layer-keyed prefetch slot."""
        return self.select("mem")

    @property
    def pipeline(self):
        """Pipeline stage-assignment rows (``pipeline=`` leg): one per
        macro-layer with its ``stage k of S`` placement and the split rule
        that fired, plus the pinned embed / head rows."""
        return self.select("pipeline")

    @property
    def fallbacks(self) -> Tuple[LeafReport, ...]:
        return tuple(l for l in self.leaves if l.fell_back)

    def coverage(self) -> dict:
        return {"param": len(self.params), "opt": len(self.opt),
                "cache": len(self.caches), "state": len(self.serve_state),
                "kernel": len(self.kernels), "mem": len(self.mem),
                "pipeline": len(self.pipeline),
                "fallbacks": len(self.fallbacks)}

    def raise_on_fallback(self) -> "PlanReport":
        """strict mode: any silently-replicated dim is an IndivisibleError."""
        if self.fallbacks:
            lines = [f"  {l.kind:5s} {l.path}: {'; '.join(l.notes)}"
                     for l in self.fallbacks]
            raise IndivisibleError(
                f"{len(self.fallbacks)} leaves of {self.model} do not divide "
                f"the {self.layout.device_matrix} matrix and would silently "
                "replicate:\n" + "\n".join(lines))
        return self

    def __str__(self) -> str:
        hdr = (f"HyperPlan resolution: model={self.model} plan="
               f"{self.plan.name or '<unnamed>'} matrix="
               f"{self.layout.device_matrix}/{self.layout.alias_name}")
        rows = [hdr, f"{'kind':6s} {'path':42s} {'shape':20s} "
                     f"{'spec':34s} {'mem':7s} rule"]
        for l in self.leaves:
            rows.append(f"{l.kind:6s} {l.path:42s} {str(l.shape):20s} "
                        f"{_spec_str(l.spec):34s} {l.memory:7s} {l.rule}")
            for n in l.notes:
                rows.append(f"       ! {n}")
        c = self.coverage()
        rows.append(f"{c['param']} params, {c['opt']} opt leaves, "
                    f"{c['cache']} cache leaves, "
                    f"{c['state']} serving-state leaves, "
                    f"{c['kernel']} kernel rows, "
                    f"{c['mem']} mem-residency rows, "
                    f"{c['pipeline']} pipeline rows, "
                    f"{c['fallbacks']} divisibility fallbacks")
        return "\n".join(rows)


def _spec_str(spec) -> str:
    """A spec tuple as the reference prints its ``PartitionSpec``."""
    if isinstance(spec, tuple):
        return "PartitionSpec(" + ", ".join(map(repr, spec)) + ")"
    return str(spec)


def _spec_offloadable(spec, layout: Layout) -> bool:
    """Only fully-sharded leaves are host-placed; the report shows the same
    selectivity the runtime applies (shared predicate)."""
    from repro_torch.core.offload import spec_fully_sharded
    return spec_fully_sharded(
        spec, {a: layout.axis_size(a) for a in layout.alias_name})


def explain(plan: HyperPlan, cfg, layout: Optional[Layout] = None, *,
            batch: int = 1, cache_len: Optional[int] = None,
            with_opt: bool = True, with_cache: bool = True,
            serving: bool = False) -> PlanReport:
    """Resolve ``plan`` for ``cfg`` on ``layout``; return the full report.

    ``serving=True`` additionally resolves the HyperServe
    :class:`~repro_torch.serve.paged_kv.StatePool` the plan's ServeConfig
    would build: one row per pool leaf with the mixer registry's state kind
    (``paged`` / ``slot`` / ``windowed(w=N)``) in the memory column and
    the :func:`~repro_torch.core.hypershard.derive_pool` rule that fired.
    A config the serving runtime cannot host raises the same typed
    ``ServePlanError`` the runtime would, naming the offending mixer.
    """
    from repro_torch.mem.planner import param_shapes
    from repro_torch.models import model as M

    layout = layout or SINGLE_DEVICE_LAYOUT
    plan = HyperPlan.coerce(plan)
    plan.validate(layout)
    splan = plan.sharding_plan()
    leaves = []

    for path, leaf in tree_flatten_with_path(param_shapes(cfg)):
        strat, rule, notes = hypershard.derive_param(path, tuple(leaf.shape),
                                                     layout, splan)
        spec = strat.partition_spec()
        host = plan.params_on_host and _spec_offloadable(spec, layout)
        leaves.append(LeafReport("param", path, tuple(leaf.shape), spec,
                                 "host" if host else "device",
                                 rule or "<default: replicate>", notes))
        if with_opt:
            # AdamW mu/nu mirror the param layout (see optim/adamw.py)
            ohost = plan.opt_state_on_host and _spec_offloadable(spec, layout)
            for moment in ("mu", "nu"):
                leaves.append(LeafReport(
                    "opt", f"{moment}/{path}", tuple(leaf.shape), spec,
                    "host" if ohost else "device",
                    rule or "<default: replicate>", notes))

    if with_cache:
        clen = cache_len or max(cfg.sliding_window, 64)
        caches = M.init_caches(cfg, batch, clen, device="meta")
        for path, leaf in tree_flatten_with_path(caches):
            strat, note, fbs = hypershard.derive_cache(
                path, tuple(leaf.shape), layout, splan, batch=batch)
            leaves.append(LeafReport("cache", path, tuple(leaf.shape),
                                     strat.partition_spec(), "device",
                                     note, fbs))

    if serving:
        leaves.extend(_serving_rows(plan, cfg, layout, splan))

    if plan.offload_policy == "graph":
        leaves.extend(_mem_rows(plan, cfg))

    if plan.fabric is not None:
        leaves.extend(_fabric_rows(plan, layout))

    if plan.pipeline is not None:
        leaves.extend(_pipeline_rows(plan, cfg))

    return PlanReport(plan, getattr(cfg, "name", str(cfg)), layout,
                      tuple(leaves))


def _serving_rows(plan: HyperPlan, cfg, layout: Layout, splan):
    """The StatePool rows and the kernel-lowering rows of ``serving``."""
    from repro_torch.kernels.ops import resolve_paged_path
    from repro_torch.models import mixers as MX
    from repro_torch.serve.engine import check_data_axis_serving
    from repro_torch.serve.paged_kv import StatePool

    # preflight the SAME device-view rule the serving engine enforces
    check_data_axis_serving({a: layout.axis_size(a)
                             for a in layout.alias_name})
    scfg = plan.serve_config()
    pcfg = scfg.paged_config(model_dtype=cfg.dtype)
    st_layout = MX.model_state_layout(cfg)   # typed error if unservable
    if plan.roles_dict():
        # disagg plans preflight the same rule the serving engine enforces
        MX.check_disagg_supported(cfg, st_layout)
    pool = StatePool(cfg, pcfg, num_slots=scfg.max_slots,
                     device="meta").state
    rows = []
    for seg in st_layout.segments:
        for j, spec in enumerate(seg.specs):
            kind_desc = spec.state
            if spec.state == MX.WINDOWED:
                kind_desc += f"(w={spec.window(cfg)})"
            for name, leaf in tree_flatten_with_path(pool[seg.name][j]):
                path = f"{seg.name}/{j}.{spec.kind}/{name}"
                strat, note, fbs = hypershard.derive_pool(
                    path, tuple(leaf.shape), layout, splan)
                rows.append(LeafReport(
                    "state", path, tuple(leaf.shape),
                    strat.partition_spec(), kind_desc, note, fbs))

    # kernel-lowering rows: which attention path each paged sub-layer
    # takes under the plan's `kernels` toggle (the same resolve the
    # serving runtime applies at engine build)
    resolved = resolve_paged_path(scfg.kernels)
    rule = f"kernels={scfg.kernels} -> {resolved}"
    for seg in st_layout.segments:
        for j, spec in enumerate(seg.specs):
            if spec.state == MX.SLOT:
                continue
            for hook in ("decode", "prefill"):
                desc = _kernel_lowering(spec, hook, resolved)
                hook_rule = rule if hook in spec.fused_hooks else (
                    f"{rule} (no fused {hook} hook)")
                rows.append(LeafReport(
                    "kernel", f"{seg.name}/{j}.{spec.kind}/{hook}",
                    (), desc, "kernel", hook_rule, ()))
    return rows


def _kernel_lowering(spec, hook: str, resolved: str) -> str:
    """Human-readable lowering for one (mixer, hook) under the resolved
    kernel path — the fused kernel's name when the hook is fused, the
    composed gather+dense pipeline otherwise."""
    mla = spec.kind == "mla"
    if resolved == "fused" and hook in spec.fused_hooks:
        if hook == "decode":
            return ("fused(paged_mla_decode_attention)" if mla
                    else "fused(paged_decode_attention)")
        return "fused(ragged_prefill_attention)"
    if hook == "decode":
        return ("composed(gather+mla_decode)" if mla
                else "composed(gather+decode_attention)")
    return ("composed(gather+mla_prefill_chunk)" if mla
            else "composed(gather+flash_rows)")


def _mem_rows(plan: HyperPlan, cfg):
    """One row per parameter leaf under ``offload_policy="graph"``: the
    HyperMem residency planner's tier in the memory column, the prefetch
    slot in the spec column (kernel rows set the precedent for descriptive
    spec strings), and the planner rule that fired."""
    from repro_torch.mem import plan_residency

    rplan = plan_residency(cfg, plan.offload_config())
    rows = []
    for ml in rplan.leaves:
        slot = ("resident" if ml.prefetch_step is None
                else f"prefetch@layer{ml.prefetch_step}"
                     f"(depth={rplan.prefetch_depth})")
        rows.append(LeafReport("mem", ml.path, ml.shape, slot, ml.tier,
                               ml.rule, ()))
    return rows


def _pipeline_rows(plan: HyperPlan, cfg):
    """One row per macro-layer with its pipeline stage assignment
    (``stage k of S`` in the spec column, ``rule=even|explicit`` in the
    rule column), plus the pinned endpoints: embeddings on the first
    stage, final-norm/unembed on the last.  Model-dependent validation
    (stage-overclaim vs the macro-layer count) fires HERE via
    :func:`repro_torch.core.pipeline.partition_stages` — the same typed
    ``PipelinePlanError`` the trainer would raise, before any carve."""
    from repro_torch.core.mpmd import pipeline_bubble_steps
    from repro_torch.core.pipeline import partition_stages, schedule_1f1b

    pcfg = plan.pipeline_config()
    asns = partition_stages(cfg, pcfg.stages, pcfg.stage_layers)
    S, M = pcfg.stages, pcfg.micro_batches
    rows = [LeafReport(
        "pipeline", "schedule/1f1b", (S, M),
        f"span={schedule_1f1b(S, M).span} ticks",
        "mpmd", f"bubble_steps={pipeline_bubble_steps(S, M)} "
                f"(sync 1F1B, {M} micro-batches)", ())]
    for asn in asns:
        for li in asn.layers:
            rows.append(LeafReport(
                "pipeline", f"layer[{li:02d}]", (),
                f"stage {asn.index} of {asn.num_stages}",
                f"stage{asn.index}", f"rule={asn.rule}", ()))
    rows.append(LeafReport(
        "pipeline", "embed", (), "stage 0 of " + str(S), "stage0",
        "pinned: embeddings on first stage", ()))
    head = "unembed" if not cfg.tie_embeddings else "unembed(tied-copy)"
    rows.append(LeafReport(
        "pipeline", f"final_norm+{head}", (),
        f"stage {S - 1} of {S}", f"stage{S - 1}",
        "pinned: readout on last stage", ()))
    return rows


def _fabric_rows(plan: HyperPlan, layout: Layout):
    """One row per fabric replica (the replica->rank-group carve) and one
    per tenant (SLO class + effective dispatch weight)."""
    from repro_torch.fabric.carve import carve_counts, describe_carve
    from repro_torch.fabric.router import SLO_POLICY

    fcfg = plan.fabric_config()
    n_dev = 1
    for a in layout.alias_name:
        n_dev *= layout.axis_size(a)
    counts = carve_counts(n_dev, fcfg)
    if fcfg.split:
        rule = "carve: explicit split"
    elif all(c == 0 for c in counts):
        rule = "carve: colocated (fewer devices than replicas)"
    else:
        rule = "carve: even split"
    rows = []
    for (label, devs), c in zip(describe_carve(counts), counts):
        rows.append(LeafReport(
            "fabric", label, (1, max(c, 1)), devs,
            "colocated" if c == 0 else "submesh", rule, ()))
    for t in fcfg.tenants:
        weight = t.weight or SLO_POLICY[t.slo]["weight"]
        rows.append(LeafReport(
            "fabric", f"tenant[{t.name}]", (), f"slo={t.slo}", "frontdoor",
            f"weighted-fair: weight={weight}"
            + (f", max_inflight={t.max_inflight}" if t.max_inflight else ""),
            ()))
    return rows
