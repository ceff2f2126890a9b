"""Configuration system of the PyTorch port.

A copy of the reference's ``repro.configs.base`` (the model, serving,
fabric, RL and pipeline configs the ported slices read), kept field for
field so one config value means the same thing in both packages.  Every
architecture is a frozen :class:`ModelConfig`; ``reduced()`` produces the
CPU-test variant (2 layers, d_model<=256).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds used to wire heterogeneous stacks (hybrid / MoE-with-dense-first)
ATTN = "attn"            # full causal attention (GQA/MHA)
LOCAL_ATTN = "local"     # sliding-window causal attention
MLA = "mla"              # multi-head latent attention (DeepSeek-V2)
SSD = "ssd"              # Mamba-2 state-space dual block
RGLRU = "rglru"          # RecurrentGemma RG-LRU block

DENSE_FFN = "dense"      # SwiGLU MLP
MOE_FFN = "moe"          # shared + routed experts
NO_FFN = "none"          # no FFN leg (mamba2 blocks)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 64            # routed experts
    num_shared_experts: int = 2
    top_k: int = 6
    d_ff_expert: int = 1408          # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    router_z_coef: float = 1e-4
    first_k_dense: int = 1           # leading layers that use a dense FFN


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0             # 0 => no query compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    conv_width: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0               # 0 => use d_model
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = (RGLRU, RGLRU, LOCAL_ATTN)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    sliding_window: int = 4096       # used by LOCAL_ATTN blocks
    long_context_window: int = 8192  # sliding-window cache used for long_500k
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # multimodal frontend stubs -------------------------------------------------
    modality: str = "text"           # text | vision | audio
    frontend_dim: int = 0            # raw embedding dim produced by the stub
    num_prefix_tokens: int = 0       # patches / conditioning frames per sample
    # numerics ------------------------------------------------------------------
    dtype: str = "bfloat16"
    source: str = ""                 # citation from the assignment pool

    # -- derived ---------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's sharding pad)."""
        return ((self.vocab_size + 255) // 256) * 256

    def block_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """Per-layer (mixer, ffn) kinds, length == num_layers."""
        out = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                mixer = SSD
            elif self.family == "hybrid":
                pat = self.rglru.block_pattern
                mixer = pat[i % len(pat)]
            elif self.mla is not None:
                mixer = MLA
            else:
                mixer = ATTN
            if self.moe is not None and i >= self.moe.first_k_dense:
                ffn = MOE_FFN
            elif self.family == "ssm":
                ffn = NO_FFN         # mamba2 blocks have no separate MLP
            else:
                ffn = DENSE_FFN
            out.append((mixer, ffn))
        return tuple(out)

    def param_count(self) -> int:
        """Analytic parameter count (the reference's, for the device-memory
        model of ``core/offload.py``)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for mixer, ffn in self.block_kinds():
            if mixer in (ATTN, LOCAL_ATTN):
                total += d * self.num_heads * hd          # Wq
                total += 2 * d * self.num_kv_heads * hd   # Wk, Wv
                total += self.num_heads * hd * d          # Wo
            elif mixer == MLA:
                m = self.mla
                qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)  # down kv
                total += m.kv_lora_rank * self.num_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                total += d * self.num_heads * qk_dim if not m.q_lora_rank \
                    else (d * m.q_lora_rank
                          + m.q_lora_rank * self.num_heads * qk_dim)
                total += self.num_heads * m.v_head_dim * d          # Wo
            elif mixer == SSD:
                s = self.ssm
                di = s.d_inner(d)
                nh = s.num_heads(d)
                total += d * (2 * di + 2 * s.d_state + nh)  # in_proj
                total += di * d                              # out_proj
                total += s.conv_width * (di + 2 * s.d_state) + 2 * nh
            elif mixer == RGLRU:
                w = self.rglru.lru_width or d
                total += 2 * d * w + w * d                   # in (x,gate), out
                total += self.rglru.conv_width * w + 2 * w   # conv + lru gates
            if ffn == DENSE_FFN:
                total += 3 * d * self.d_ff
            elif ffn == MOE_FFN:
                mo = self.moe
                total += d * mo.num_experts                  # router
                total += 3 * d * mo.d_ff_expert * (mo.num_experts
                                                   + mo.num_shared_experts)
        total += 2 * L * d                                   # norms (approx)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-in experts count)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        inactive_per_moe_layer = 3 * self.d_model * mo.d_ff_expert * (
            mo.num_experts - mo.top_k)
        n_moe_layers = sum(1 for _, f in self.block_kinds() if f == MOE_FFN)
        return self.param_count() - n_moe_layers * inactive_per_moe_layer

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        # keep GQA ratio representative but legal
        while heads % kv:
            kv -= 1
        hd = d // heads
        kw = dict(
            num_layers=2, d_model=d, num_heads=heads, num_kv_heads=kv,
            head_dim=hd, d_ff=min(self.d_ff, 4 * d) or 4 * d,
            vocab_size=min(self.vocab_size, 1024),
            sliding_window=64, long_context_window=128,
            frontend_dim=min(self.frontend_dim, 2 * d) if self.frontend_dim else 0,
            num_prefix_tokens=min(self.num_prefix_tokens, 8),
        )
        if self.moe is not None:
            kw["moe"] = replace(self.moe, num_experts=4, num_shared_experts=1,
                                top_k=2, d_ff_expert=min(self.moe.d_ff_expert, d),
                                first_k_dense=1)
        if self.mla is not None:
            kw["mla"] = replace(self.mla, kv_lora_rank=64, qk_nope_head_dim=hd,
                                qk_rope_head_dim=hd // 2, v_head_dim=hd)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=32, chunk_size=32)
        if self.rglru is not None:
            kw["rglru"] = replace(self.rglru, lru_width=d)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# HyperServe runtime knobs (paged pool + continuous-batching scheduler)
@dataclass(frozen=True)
class ServeConfig:
    """Serving-runtime configuration, decoupled from the model config.

    Block knobs size the paged KV pool; scheduler knobs bound the
    continuous batch.  ``max_blocks_per_req`` caps a request's context at
    ``block_size * max_blocks_per_req`` tokens and fixes the block-table
    width every step runs with.
    """
    # paged KV pool
    block_size: int = 16               # tokens per pool block
    num_blocks: int = 128              # pool size (block 0 is the null block)
    max_blocks_per_req: int = 16       # block-table width
    dtype: str = ""                    # "" => model dtype
    # continuous-batching scheduler
    max_slots: int = 4                 # decode batch seats
    max_queue: int = 64                # admission control: reject beyond this
    prefill_chunk: int = 32            # chunked-prefill granularity
    prefill_chunks_per_step: int = 4   # prefill/decode interleave budget
    # rows of the BATCHED prefill step: all chunks the scheduler admits in
    # one iteration run as one call, filler rows padded to the null slot
    prefill_batch: int = 4
    watermark_blocks: int = 1          # admission headroom for decode growth
    # copy-on-write prompt-prefix sharing
    enable_prefix_cache: bool = True
    prefix_cache_blocks: int = 32      # LRU cap on retained blocks
    # HyperMem hierarchical archive: byte budgets for the preemption
    # archive's host tier (LRU-spills to disk beyond this) and disk tier
    # (a disk full of pinned spill state raises MemCapacityError); 0 =
    # unbounded.  On a mesh each rank stores its own shard of a spilled
    # leaf, but both budgets count the leaf's global bytes, as the
    # reference's do, so every rank evicts alike and as with no mesh
    archive_host_bytes: int = 0
    archive_disk_bytes: int = 0
    # predictive restore: stage archived pages for PREEMPTED requests
    # within this many queue positions of the head.  0 disables.
    restore_lookahead: int = 2
    # attention lowering for the paged steps:
    #   "fused"    — the block-table-walking kernels (CUDA on the card,
    #                their plain PyTorch versions on CPU tensors)
    #   "composed" — gather tables -> the dense decode_attention /
    #                flash_attention kernels
    #   "auto"     — fused
    kernels: str = "auto"

    def replace(self, **kw) -> "ServeConfig":
        return replace(self, **kw)

    def validate(self) -> "ServeConfig":
        """Eager knob check; typed ServePlanError before any step runs."""
        from repro_torch.api.errors import ServePlanError
        problems = []
        for knob, lo in (("block_size", 1), ("num_blocks", 2),
                         ("max_blocks_per_req", 1), ("max_slots", 1),
                         ("max_queue", 1), ("prefill_chunk", 1),
                         ("prefill_chunks_per_step", 1), ("prefill_batch", 1),
                         ("watermark_blocks", 0), ("prefix_cache_blocks", 0),
                         ("archive_host_bytes", 0), ("archive_disk_bytes", 0),
                         ("restore_lookahead", 0)):
            if getattr(self, knob) < lo:
                problems.append(f"{knob}={getattr(self, knob)} (must be "
                                f">= {lo})")
        if self.kernels not in ("auto", "fused", "composed"):
            problems.append(f"kernels={self.kernels!r} (must be one of "
                            f"'auto', 'fused', 'composed')")
        if problems:
            raise ServePlanError("invalid ServeConfig: "
                                 + "; ".join(problems))
        return self

    # The paged-pool and scheduler sub-configs are derived by field name so
    # each knob has one source of truth here; a field added to either
    # sub-config must be mirrored (same name) or it fails loudly below.
    def _sub(self, cls, **overrides):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in overrides:
                kw[f.name] = overrides[f.name]
            elif hasattr(self, f.name):
                kw[f.name] = getattr(self, f.name)
            elif f.default is dataclasses.MISSING:
                raise TypeError(f"{cls.__name__}.{f.name} has no ServeConfig "
                                "counterpart and no default")
        return cls(**kw)

    def paged_config(self, *, model_dtype: str = "bfloat16"):
        from repro_torch.serve.paged_kv import PagedKVConfig
        return self._sub(PagedKVConfig, dtype=self.dtype or model_dtype)

    def scheduler_config(self):
        from repro_torch.serve.scheduler import SchedulerConfig
        return self._sub(SchedulerConfig)


# ---------------------------------------------------------------------------
# HyperFabric: multi-tenant serving-fabric knobs (the tier ABOVE HyperServe)
SLO_CLASSES = ("interactive", "batch")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant of the serving fabric: an SLO class plus fairness knobs.

    ``weight`` drives the front door's weighted-fair dispatch (0 defers to
    the class default: interactive 4, batch 1 — latency-sensitive traffic
    gets 4x the dispatch bandwidth under contention).  ``max_inflight``
    caps the tenant's outstanding requests (pending + dispatched, 0 =
    unlimited); beyond it submits raise the typed ``over_quota``
    rejection so one tenant can never occupy the whole front door.
    """
    name: str
    slo: str = "interactive"           # one of SLO_CLASSES
    weight: int = 0                    # 0 => class default
    max_inflight: int = 0              # per-tenant outstanding cap (0 = off)


@dataclass(frozen=True)
class FabricConfig:
    """Multi-tenant fabric configuration (router + replica carve).

    ``replicas`` engines serve the same model on distinct submeshes
    carved from one Supernode; ``split`` pins explicit device counts per
    replica (heterogeneous big/small capacity — the H2 hyper-heterogeneity
    serving story), empty = even split.  Front-door knobs bound the
    global queue (``max_pending``) and how deep each replica's own
    engine queue may grow before the router stops feeding it
    (``dispatch_depth`` — shallow keeps scheduling authority at the
    front door, where SLO classes exist).  Elastic knobs drain idle
    replicas and re-activate them when the pending queue deepens.
    """
    replicas: int = 2
    split: Tuple[int, ...] = ()        # devices per replica; () => even
    tenants: Tuple[TenantSpec, ...] = (TenantSpec("default"),)
    max_pending: int = 64              # bounded global front-door queue
    dispatch_depth: int = 1            # engine-queued requests per replica
    retry_after_s: float = 0.05        # backpressure hint on queue_full
    affinity: bool = True              # CoW prefix-affinity routing
    # elastic replica scale (drain/activate)
    elastic: bool = False
    min_replicas: int = 1              # never drain below this
    scale_up_pending: int = 8          # pending depth that re-activates
    scale_down_occupancy: float = 0.25 # drain only below this occupancy

    def replace(self, **kw) -> "FabricConfig":
        return replace(self, **kw)

    def validate(self) -> "FabricConfig":
        """Eager knob check; typed FabricPlanError BEFORE any engine builds."""
        from repro_torch.api.errors import FabricPlanError
        problems = []
        if self.replicas < 1:
            problems.append(f"replicas={self.replicas} (must be >= 1)")
        if self.split:
            if len(self.split) != self.replicas:
                problems.append(f"split={self.split} has {len(self.split)} "
                                f"entries for replicas={self.replicas}")
            if any(c < 1 for c in self.split):
                problems.append(f"split={self.split} (every replica needs "
                                ">= 1 device)")
        if not self.tenants:
            problems.append("tenants=() (the fabric needs >= 1 tenant)")
        seen = set()
        for t in self.tenants:
            if t.name in seen:
                problems.append(f"duplicate tenant {t.name!r}")
            seen.add(t.name)
            if t.slo not in SLO_CLASSES:
                problems.append(f"tenant {t.name!r} slo={t.slo!r} (must be "
                                f"one of {SLO_CLASSES})")
            if t.weight < 0 or t.max_inflight < 0:
                problems.append(f"tenant {t.name!r} weight/max_inflight "
                                "must be >= 0")
        for knob, lo in (("max_pending", 1), ("dispatch_depth", 1),
                         ("min_replicas", 1), ("scale_up_pending", 1)):
            if getattr(self, knob) < lo:
                problems.append(f"{knob}={getattr(self, knob)} (must be "
                                f">= {lo})")
        if self.min_replicas > self.replicas:
            problems.append(f"min_replicas={self.min_replicas} > "
                            f"replicas={self.replicas}")
        if not 0.0 <= self.scale_down_occupancy <= 1.0:
            problems.append(f"scale_down_occupancy="
                            f"{self.scale_down_occupancy} (must be in "
                            "[0, 1])")
        if problems:
            raise FabricPlanError("invalid FabricConfig: "
                                  + "; ".join(problems))
        return self


# ---------------------------------------------------------------------------
# RL post-training knobs (paper §3.3c sample-evaluate-update loops)
@dataclass(frozen=True)
class RLConfig:
    """HyperRL runtime configuration (GRPO-style post-training).

    Rollout knobs drive the actor's continuous-batching fan-out (each
    prompt is sampled ``group_size`` times for group-relative advantages);
    update knobs parameterise the masked clipped policy-gradient loss.
    """
    # rollout (actor)
    group_size: int = 4                # GRPO samples per prompt
    prompts_per_iter: int = 2          # prompt groups per iteration
    max_new_tokens: int = 8            # rollout length budget
    temperature: float = 1.0           # sampling temperature (>0)
    # update (learner)
    lr: float = 1e-5
    clip_eps: float = 0.2              # PPO-style ratio clip
    adv_eps: float = 1e-6              # group-advantage std floor
    iterations: int = 3                # default loop length (launcher/example)

    def replace(self, **kw) -> "RLConfig":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# HyperParallel-Mpipe: pipeline-parallel training knobs (the pipeline leg)
@dataclass(frozen=True)
class PipelineConfig:
    """Pipeline-parallel training configuration (synchronous 1F1B).

    ``stages`` contiguous layer stages run on disjoint groups of ranks
    (MPMD role groups, one per stage); the global batch splits into
    ``micro_batches`` micro-batches flowing through the warmup -> steady
    1F1B -> drain schedule.  ``stage_layers`` pins explicit per-stage
    macro-layer counts (empty = even split); ``stage_mesh`` pins each
    stage group's (data, model) mesh for fsdp x tp *inside* the stage
    (empty = all of the stage's ranks on the model axis).
    """
    stages: int = 2                    # pipeline stages (contiguous layers)
    micro_batches: int = 4             # micro-batches per optimizer step
    stage_layers: Tuple[int, ...] = () # explicit per-stage layer counts
    stage_mesh: Tuple[int, ...] = ()   # (data, model) shape per stage mesh

    def replace(self, **kw) -> "PipelineConfig":
        return replace(self, **kw)

    def validate(self) -> "PipelineConfig":
        """Eager knob check; typed PipelinePlanError BEFORE any carve.

        Model-dependent checks (stage-overclaim vs the macro-layer count)
        live in :func:`repro_torch.core.pipeline.partition_stages`, which
        fires when the trainer is built with a config in hand.
        """
        from repro_torch.api.errors import PipelinePlanError
        problems = []
        if self.stages < 1:
            problems.append(f"stages={self.stages} (must be >= 1)")
        if self.micro_batches < 1:
            problems.append(f"micro_batches={self.micro_batches} "
                            "(must be >= 1)")
        if self.stage_layers:
            if len(self.stage_layers) != self.stages:
                problems.append(
                    f"stage_layers={self.stage_layers} has "
                    f"{len(self.stage_layers)} entries for "
                    f"stages={self.stages}")
            if any(c < 1 for c in self.stage_layers):
                problems.append(f"stage_layers={self.stage_layers} "
                                "(every stage needs >= 1 macro-layer)")
        if self.stage_mesh:
            if len(self.stage_mesh) != 2:
                problems.append(f"stage_mesh={self.stage_mesh} (must be a "
                                "(data, model) pair)")
            elif any(n < 1 for n in self.stage_mesh):
                problems.append(f"stage_mesh={self.stage_mesh} (axis sizes "
                                "must be >= 1)")
        if problems:
            raise PipelinePlanError("invalid PipelineConfig: "
                                    + "; ".join(problems))
        return self


# ---------------------------------------------------------------------------
# Input shapes (a copy of the reference's): ``seq_len`` tokens a row,
# ``global_batch`` rows a step
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Registry
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    if not _REGISTRY:
        _load_all()
    return tuple(sorted(_REGISTRY))


def _load_all() -> None:
    # import every module in this package so configs self-register
    from repro_torch.configs import (deepseek_moe_16b,  # noqa: F401
                                     deepseek_v2_lite_16b, granite_3_2b,
                                     internvl2_26b, llama3_8b, mamba2_370m,
                                     moonshot_v1_16b_a3b, musicgen_large,
                                     phi4_mini_3_8b, qwen2_0_5b,
                                     recurrentgemma_2b)
