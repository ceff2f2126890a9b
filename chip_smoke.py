#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits non-zero:

  1. device   — card name and power limit (nvidia-smi), torch/CUDA versions;
  2. build    — nvcc builds both CUDA kernels from ``src/repro_torch``;
  3. kernels  — each kernel against its plain PyTorch version on the card at
                the serving shapes (H=14, KV=2, D=64, block 16; decode B=16,
                prefill P=4, C=256 with a filler row), bf16 and f32, with and
                without a window; timed beside its plain version, an SDPA
                yardstick and its bound;
  4. serve    — qwen2-0.5b at full width (24 layers, random weights from a
                seed) in bf16 through HyperServe continuous batching; the
                kernels must launch 24 times per decode step / prefill call;
  5. profile  — torch.profiler over one prefill call and over steady
                decode steps of the same server: device time by kernel
                against wall time, and the device's idle share;
  6. identity — greedy tokens in float32 identical with the kernels and with
                the plain versions (``ops.set_mode("ref")``);
  7. preempt  — a pool smaller than the working set preempts, spills and
                restores, with tokens identical to an ample pool;
  8. result   — the nvidia-smi line, the kernel JSON line, and
                ``{"ok": true, "device": {...}}`` as the last line.

It needs one CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

SEED = 0
DEVICE = "cuda"
# serving shapes of the main path (ServeConfig below)
H, KV, D, BS = 14, 2, 64, 16
DEC_B, NUM_BLOCKS, TABLE_W = 16, 2048, 128
PRE_P, PRE_C = 4, 256
WINDOW = 256
F32_TOL = 2e-5         # float32: the same sums in another order
# bfloat16: both the kernels and the plain versions compute in float32 and
# round once to bfloat16, so the kernel must be within one bfloat16 step of
# the plain version and within half a step (a correct rounding) of the
# plain version's float32 result on the same inputs; BF16_ABS covers the
# float32 differences (<= 1.1e-6 measured) where a step is smaller.
BF16_ABS = 4e-6
REPEATS = 30
PREEMPT_BLOCKS = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(fn, torch, repeats: int = REPEATS) -> float:
    """Median device time of ``fn()`` in ms over ``repeats`` launches, each
    with a cold L2 (a 128 MB buffer is rewritten before every launch, as a
    serving step finds the previous layer's data evicted)."""
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()                                            # warm up
    times = []
    for _ in range(repeats):
        flush.zero_()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# kernel inputs at the serving shapes
# ---------------------------------------------------------------------------
def bf16_step(torch, x):
    """Spacing of the bfloat16 numbers (8 significant bits) at |x|."""
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def parity(torch, dtype_name, got, want, want32):
    """(max abs error against the plain version, worst share of the
    allowed error; <= 1 passes)."""
    err = (got.float() - want.float()).abs()
    if dtype_name == "float32":
        return err.max().item(), err.max().item() / F32_TOL
    step = bf16_step(torch, want)
    share = err / (step + BF16_ABS)
    err32 = (got.float() - want32).abs()
    share32 = err32 / (0.5 * bf16_step(torch, want32) + BF16_ABS)
    return err.max().item(), max(share.max().item(), share32.max().item())


def decode_inputs(torch, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(SEED)
    # mixed lengths: prompts of 100..1500 plus up to 64 generated tokens;
    # most end in a partial page, one fills its last page exactly
    lengths = torch.randint(100, 1565, (DEC_B,), generator=g)
    lengths[0] = 16 * 40
    perm = torch.randperm(NUM_BLOCKS - 1, generator=g) + 1
    tables = torch.zeros(DEC_B, TABLE_W, dtype=torch.int32)
    used = 0
    for b in range(DEC_B):
        n = -(-int(lengths[b]) // BS)
        tables[b, :n] = perm[used:used + n]
        used += n
    q = torch.randn(DEC_B, 1, H, D, generator=g)
    k_pool = torch.randn(NUM_BLOCKS, BS, KV, D, generator=g)
    v_pool = torch.randn(NUM_BLOCKS, BS, KV, D, generator=g)
    to = dict(device=device)
    return (q.to(dtype=dtype, **to), k_pool.to(dtype=dtype, **to),
            v_pool.to(dtype=dtype, **to), tables.to(**to),
            lengths.to(torch.int32).to(**to))


def prefill_inputs(torch, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    # rows: a first chunk, a middle chunk of a long prompt, a final partial
    # chunk (limit inside the chunk), and one filler row (limit 0)
    starts = torch.tensor([0, 768, 1280, 0], dtype=torch.int32)
    limits = torch.tensor([900, 1400, 1400, 0], dtype=torch.int32)
    perm = torch.randperm(NUM_BLOCKS - 1, generator=g) + 1
    tables = torch.zeros(PRE_P, TABLE_W, dtype=torch.int32)
    used = 0
    for p in range(PRE_P):
        n = -(-int(limits[p]) // BS)
        tables[p, :n] = perm[used:used + n]
        used += n
    q = torch.randn(PRE_P, PRE_C, H, D, generator=g)
    k_pool = torch.randn(NUM_BLOCKS, BS, KV, D, generator=g)
    v_pool = torch.randn(NUM_BLOCKS, BS, KV, D, generator=g)
    to = dict(device=device)
    return (q.to(dtype=dtype, **to), k_pool.to(dtype=dtype, **to),
            v_pool.to(dtype=dtype, **to), tables.to(**to), starts.to(**to),
            limits.to(**to))


def sdpa_decode(torch, q, k_pool, v_pool, tables, lengths):
    """Yardstick: one SDPA call over K/V gathered densely beforehand (the
    gather and the GQA head expansion are outside the call)."""
    import torch.nn.functional as F
    B = q.shape[0]
    npg = -(-int(lengths.max()) // BS)
    S = npg * BS
    idx = tables[:, :npg].long()
    k = k_pool[idx].reshape(B, S, KV, D).repeat_interleave(H // KV, 2)
    v = v_pool[idx].reshape(B, S, KV, D).repeat_interleave(H // KV, 2)
    k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()                       # (B, H, 1, D)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def sdpa_prefill(torch, q, k_pool, v_pool, tables, starts, limits):
    import torch.nn.functional as F
    P, C = q.shape[:2]
    npg = -(-int((starts + C).max()) // BS)
    S = npg * BS
    idx = tables[:, :npg].long()
    k = k_pool[idx].reshape(P, S, KV, D).repeat_interleave(H // KV, 2)
    v = v_pool[idx].reshape(P, S, KV, D).repeat_interleave(H // KV, 2)
    k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()                       # (P, H, C, D)
    qp = starts.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= qp[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs one CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(["paged_decode_attention", "ragged_prefill_attention"])
    log(f"[build] {time.perf_counter() - t0:.1f}s into {build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "built " in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(torch):
    from repro_torch.kernels import perf_model as pm
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_ref)
    from repro_torch.kernels.ragged_prefill_attention import (
        ragged_prefill_attention, ragged_prefill_attention_ref)
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        dec = decode_inputs(torch, dtype, DEVICE)
        pre = prefill_inputs(torch, dtype, DEVICE)
        dec32 = [t.float() if t.is_floating_point() else t for t in dec]
        pre32 = [t.float() if t.is_floating_point() else t for t in pre]
        for window in (None, WINDOW):
            kw = dict(block_size=BS, window=window)
            got = paged_decode_attention(*dec, **kw)
            err_d, share_d = parity(
                torch, dtype_name, got, paged_decode_attention_ref(*dec, **kw),
                paged_decode_attention_ref(*dec32, **kw))
            got = ragged_prefill_attention(*pre, **kw)
            err_p, share_p = parity(
                torch, dtype_name, got,
                ragged_prefill_attention_ref(*pre, **kw),
                ragged_prefill_attention_ref(*pre32, **kw))
            sync(torch)
            filler_zero = bool((got[3] == 0).all().item())
            limit = (f"{F32_TOL} abs" if dtype_name == "float32" else
                     "one bf16 step of the plain version and half a step "
                     f"of its f32 result, + {BF16_ABS}")
            log(f"[kernels] {dtype_name} window={window}: decode max_abs_err="
                f"{err_d:.3e} ({share_d:.3f} of allowed), prefill "
                f"max_abs_err={err_p:.3e} ({share_p:.3f} of allowed), filler "
                f"row exactly zero={filler_zero} (limit: {limit})")
            if not (share_d <= 1 and share_p <= 1 and filler_zero):
                raise AssertionError(f"kernel parity failed ({dtype_name}, "
                                     f"window={window})")
            if window is None:
                rows[dtype_name] = (dec, pre, err_d, err_p)
    if DEVICE != "cuda":
        return []

    # timing at the main path's dtype (bf16), no window
    dec, pre, err_d, err_p = rows["bfloat16"]
    kw = dict(block_size=BS)
    # the bound counts the work this run's inputs need (visible keys and
    # pairs); the reference's pages-visited model is printed beside it
    lengths = dec[4].tolist()
    _, _, _, _, starts, limits = pre
    starts, limits = starts.tolist(), limits.tolist()
    shape = dict(num_heads=H, kv_heads=KV, head_dim=D, itemsize=2)
    dec_cost = pm.decode_visible_cost(lengths, **shape)
    dec_pages = pm.paged_decode_cost(
        batch=DEC_B, block_size=BS, **shape,
        pages_visited=pm.decode_pages_visited(lengths, block_size=BS))
    pre_cost = pm.prefill_visible_cost(starts, limits, PRE_C, **shape)
    pre_pages = pm.ragged_prefill_cost(
        rows_live=sum(n > 0 for n in limits), chunk=PRE_C, block_size=BS,
        **shape, pages_visited=pm.prefill_pages_visited(
            starts, limits, PRE_C, block_size=BS, table_width=TABLE_W))
    out = []
    for name, fn, ref, args, cost, pages, err, lib, source, replaces in (
            ("paged_decode_attention", paged_decode_attention,
             paged_decode_attention_ref, dec, dec_cost, dec_pages, err_d,
             sdpa_decode(torch, *dec),
             "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
             "src/repro/kernels/paged_decode_attention.py:91"),
            ("ragged_prefill_attention", ragged_prefill_attention,
             ragged_prefill_attention_ref, pre, pre_cost, pre_pages, err_p,
             sdpa_prefill(torch, *pre),
             "src/repro_torch/kernels/csrc/ragged_prefill_attention.cu",
             "src/repro/kernels/ragged_prefill_attention.py:89")):
        ms = time_ms(lambda: fn(*args, **kw), torch)
        plain_ms = time_ms(lambda: ref(*args, **kw), torch)
        library_ms = time_ms(lib, torch)
        bound_ms = cost.bound_seconds("bfloat16") * 1e3
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": cost.bound_by("bfloat16"),
               "library_ms": library_ms}
        log(f"[kernels] {name} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"SDPA on pre-gathered K/V (gather excluded) {library_ms:.4f} "
            f"ms, bound {bound_ms:.5f} ms ({row['bound_by']}: visible work "
            f"{cost.flops:.4g} flop, {cost.hbm_bytes:.4g} B; the "
            f"reference's pages-visited model: {pages.flops:.4g} flop, "
            f"{pages.hbm_bytes:.4g} B, "
            f"{pages.bound_seconds('bfloat16') * 1e3:.5f} ms)")
        out.append(row)
    return out


def make_prompts(rng, n, lo, hi, vocab):
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def serve_all(serve, prompts, max_new):
    rids = [serve.submit(p, max_new) for p in prompts]
    out = serve.join()
    return [out[r] for r in rids], rids


def phase_serve(torch, np):
    from repro_torch.configs.base import ServeConfig, get_config
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.ragged_prefill_attention import \
        ragged_prefill_attention
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    cfg = get_config("qwen2-0.5b")
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    scfg = ServeConfig(block_size=BS, num_blocks=NUM_BLOCKS,
                       max_blocks_per_req=TABLE_W, max_slots=DEC_B,
                       prefill_chunk=PRE_C, prefill_batch=PRE_P)
    serve = HyperServe(cfg, params, serve_cfg=scfg, device=DEVICE)
    rng = np.random.default_rng(SEED)
    serve_all(serve, make_prompts(rng, 2, 50, 60, cfg.vocab_size), 4)  # warm
    prompts = make_prompts(rng, 16, 100, 1500, cfg.vocab_size)
    eng = serve.engine
    m = eng.obs.metrics
    before = {k: m.counter(k).value for k in
              ("serve.kernels.decode.fused", "serve.prefill_calls",
               "serve.prefill_chunks", "serve.preemptions")}
    itl0 = m.histogram("serve.itl_s").sum
    tokens0 = eng.tokens_generated
    # the main path's run: every launch count starts at 0 here
    paged_decode_attention.launches = 0
    ragged_prefill_attention.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    outs, rids = serve_all(serve, prompts, 64)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "ragged_prefill_attention": ragged_prefill_attention.launches}
    d = {k: m.counter(k).value - v for k, v in before.items()}
    steps, calls = int(d["serve.kernels.decode.fused"]), \
        int(d["serve.prefill_calls"])
    tokens = eng.tokens_generated - tokens0
    decode_s = m.histogram("serve.itl_s").sum - itl0
    decode_tokens = tokens - len(prompts)      # first tokens come of prefill
    ttfts = sorted(serve.request_meta(r)["ttft_s"] for r in rids)
    finished = sum(serve.state(r) == "finished" for r in rids)
    log(f"[serve] qwen2-0.5b bf16 full width: {finished}/{len(prompts)} "
        f"requests finished, {tokens} tokens in {wall:.3f}s "
        f"({tokens / wall:.1f} tok/s overall), decode {decode_tokens} tokens "
        f"in {steps} steps, {decode_s:.3f}s ({decode_tokens / decode_s:.1f} "
        f"decode tok/s), median TTFT {ttfts[len(ttfts) // 2]:.3f}s (all "
        f"submitted at t=0), prefill_calls={calls} prefill_chunks="
        f"{int(d['serve.prefill_chunks'])}, preemptions="
        f"{int(d['serve.preemptions'])}")
    n = cfg.num_layers
    log(f"[serve] launches {launches}; expected decode {n} x {steps} = "
        f"{n * steps}, prefill {n} x {calls} = {n * calls}")
    if finished != len(prompts) or any(len(o) != 64 for o in outs):
        raise AssertionError("not every request finished with 64 tokens")
    if (launches["paged_decode_attention"] != cfg.num_layers * steps
            or launches["ragged_prefill_attention"] != cfg.num_layers * calls
            or steps == 0 or calls == 0):
        raise AssertionError(f"launch counts {launches} do not match "
                             f"{cfg.num_layers} x (steps={steps}, "
                             f"calls={calls})")
    return launches, serve, prompts


def _device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:                                  # older torch
        us = evt.self_cuda_time_total
    return us / 1e3


def phase_profile(torch, serve, prompts):
    """Where a step's time goes: torch.profiler over one prefill call (the
    first step of a fresh batch) and over steady decode steps, device time
    by kernel against the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for p in prompts:
        serve.submit(p, 64)
    windows = []
    with profile(activities=acts) as prof:
        sync(torch)
        t0 = time.perf_counter()
        serve.step_once()                    # admits 16, prefills 4 chunks
        sync(torch)
        windows.append(("prefill call", prof, time.perf_counter() - t0, 1))
    sched = serve.engine.scheduler
    while any(r.state.value == "prefilling" for r in sched.active):
        serve.step_once()
    n = 8
    with profile(activities=acts) as prof:
        sync(torch)
        t0 = time.perf_counter()
        for _ in range(n):
            serve.step_once()
        sync(torch)
        windows.append(("decode step", prof, time.perf_counter() - t0, n))
    for name, prof, wall, steps in windows:
        # device-side rows only (kernels, copies): an operator's row also
        # carries its kernels' time, which would count it twice
        rows = [(e.key, _device_ms(e) / steps) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and _device_ms(e) > 0]
        rows.sort(key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in rows)
        wall_ms = wall * 1e3 / steps
        log(f"[profile] {name}: wall {wall_ms:.3f} ms, device busy "
            f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}")
        for key, ms in rows[:8]:
            log(f"[profile]   {ms:8.4f} ms  {ms / busy:6.1%}  {key[:70]}")
        if busy <= 0:
            raise AssertionError("the profiler saw no device time")
    serve.join()


def phase_identity(torch, np):
    from repro_torch.configs.base import ServeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), dtype="float32")
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    scfg = ServeConfig(block_size=BS, num_blocks=512, max_blocks_per_req=64,
                       max_slots=8, prefill_chunk=PRE_C, prefill_batch=PRE_P)
    prompts = make_prompts(np.random.default_rng(SEED + 2), 6, 100, 700,
                           cfg.vocab_size)
    runs = {}
    for mode in ("auto", "ref"):
        ops.set_mode(mode)
        try:
            runs[mode], _ = serve_all(HyperServe(
                cfg, params, serve_cfg=scfg, device=DEVICE), prompts, 32)
        finally:
            ops.set_mode("auto")
    for i, (a, b) in enumerate(zip(runs["auto"], runs["ref"])):
        if a != b:
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            raise AssertionError(f"request {i}: first divergence at token "
                                 f"{j}: kernels {a[j]} vs plain {b[j]}")
    log(f"[identity] f32 greedy tokens identical, kernels vs plain versions: "
        f"{len(prompts)} requests x 32 tokens")
    return cfg, params


def phase_preempt(torch, np, cfg, params):
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve.api import HyperServe
    prompts = make_prompts(np.random.default_rng(SEED + 3), 4, 180, 220,
                           cfg.vocab_size)
    base = dict(block_size=BS, max_blocks_per_req=24, max_slots=4,
                prefill_chunk=PRE_C, enable_prefix_cache=False)
    ample, _ = serve_all(HyperServe(cfg, params, serve_cfg=ServeConfig(
        num_blocks=256, **base), device=DEVICE), prompts, 64)
    tight = HyperServe(cfg, params, device=DEVICE,
                       serve_cfg=ServeConfig(num_blocks=PREEMPT_BLOCKS, **base))
    got, _ = serve_all(tight, prompts, 64)
    st = tight.stats()
    m = tight.engine.obs.metrics
    spills, restores = (int(m.counter("serve.spills").value),
                        int(m.counter("serve.restores").value))
    log(f"[preempt] pool {PREEMPT_BLOCKS - 1} blocks for a working set of "
        f"{sum(-(-(len(p) + 64) // BS) for p in prompts)}: preemptions="
        f"{st['preemptions']} spills={spills} restores={restores} "
        f"prefetch hits={st['prefetch_hits']}, tokens identical to the "
        f"ample pool: {got == ample}")
    if st["preemptions"] < 1 or spills < 1 or restores < 1 or got != ample:
        raise AssertionError("preemption phase failed")


def main() -> int:
    import repro_torch  # noqa: F401  (the port must be here, card or not)
    import numpy as np
    import torch
    smi = phase_device(torch)
    phase_build()
    rows = phase_kernels(torch)
    launches, serve, prompts = phase_serve(torch, np)
    for row in rows:
        row["launches"] = launches[row["name"]]
    phase_profile(torch, serve, prompts)
    del serve
    cfg32, params32 = phase_identity(torch, np)
    phase_preempt(torch, np, cfg32, params32)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
