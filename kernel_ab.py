#!/usr/bin/env python3
"""Time the kernels of two or more checkouts of this repository on one
NVIDIA card, each checkout in its own process, in the order A, B, B, A
(A, B, C, C, B, A for three).

    python3 kernel_ab.py A_DIR B_DIR [C_DIR ...] [CASE ...]
                                     # unpacked checkouts (the arguments
                                     # that are directories), A first;
                                     # CASEs: prefixes of the case names
                                     # to time

Each process builds its checkout's kernels (into that checkout's
``build/``), holds each against that checkout's plain version, and times
it through the checkout's wrapper at the qwen2-0.5b shapes of
``chip_smoke.py`` (H=14, KV=2, D=64, bf16): flash_attention at the
Generator prefill (B=8, S=1024, causal), decode_attention at the
Generator's decode (B=8 over a 1096-entry cache, lengths 1025..1087),
paged_decode_attention at the serving decode (16 seats, block 16,
lengths 100..1564) and ragged_prefill_attention at a serving prefill call
(4 rows of 256, one a filler); and the kernels at the other rows of
PERF.md's kernel table: the ragged prefill at recurrentgemma-2b's
(H, KV, D) = (10, 1, 256), window 2048, over ``chip_smoke.py``'s
RG_PRE_ROWS (a row past the window, a filler), flash at (256, 256) over
8 x 1024 with that window, and flash at deepseek-v2-lite's (Dk, Dv) =
(192, 128) over its prefill call's rows (4 x 256 queries at offsets 0,
256, 768, 1280 over 1536 keys); decode_attention at recurrentgemma-2b's
Generator decode (8 rows over 1096 entries, (10, 1, 256)); the paged
decode at recurrentgemma-2b's serving decode (16 seats of 100..3064 keys
over a 194-block table, window 2048, the blocks below it null:
``chip_smoke.py``'s rg_cases inputs); rglru_scan at recurrentgemma-2b's
serving prefill call (4 rows x 256 x 2560 with a bf16 initial state, one
row padded past its limit, a filler row) and its Generator prefill (8 x
1024 x 2560); the grouped
matmul at ``chip_smoke.py``'s five deepseek-v2-lite cases (a decode step's
16 x top-6 = 96 rows and a prefill call's 4 x 256 x 6 = 6144, for the
w_gate/w_up (2048 -> 1408) and w_down (1408 -> 2048) shapes over 64
experts, and the 6144 rows all in one expert); its backward's dx and dw
(in trees that have them) at the train step's 49152 rows
("grouped_matmul_bwd train") and the RL update's 2304
("grouped_matmul_bwd rl"), both shapes, each with its bound;
mamba2-370m's ssd_scan at
``chip_smoke.py``'s serving prefill call (4 rows x 256 with a bf16 initial
state, one row padded past its limit, a filler row; its SSM_ROWS) and its
Generator prefill (8 x 1024, chunks of 256), x, B and C column slices of
one (rows, S, 2304) tensor as the layer hands them over; and
deepseek-v2-lite's paged_mla_decode_attention at the serving decode (16
seats over a 96-block table, block 16, lengths 100..1532); flash's
backward at qwen2-0.5b's train shape (4 x 4096, causal), at (24, 8,
128) over 2 x 2048 ("flash_attention_bwd wide") and at deepseek-v2-lite's
(192, 128) over 2 x 4096 ("flash_attention_bwd mla"; cases only in trees
whose backward takes them); each case from ``chip_smoke.py``'s seeds, so its
inputs are those of phase 3; and, in trees that have them, the backwards of
recurrentgemma-2b's train step: flash at (256, 256), G = 10, window 2048,
over 1 x 4096 ("flash_attention_bwd d256 g10") and rglru_scan_bwd over 1 x
4096 x 2560, and mamba2-370m's ssd_scan_bwd over 4 x 4096 (H = 32, (64,
128), chunks of 256): "ssd_scan_bwd train", "rglru_scan_bwd train".
Each tree also prints ptxas's registers and spill stores for the flash
forward, the ragged prefill, the attention and scan backwards and both
grouped matmul sources.  With two timers, ROUNDS readings each:

* queued -- every launch queued behind a cold-L2 flush and one wait at
  the end, the card held busy (``torch.cuda._sleep``) while the host
  enqueues each launch, so the host's time per call is never counted: the
  kernels' own device time (the ``time_ms`` of ``chip_smoke.py``);
* synced -- a wait after every launch, so host time that the card does
  not hide is counted too;

a backward's time split by kernel (``kernels``: torch.profiler's device
time of each kernel over SPLIT_CALLS calls, each behind a cold-L2 flush);
and the host's own time of one wrapper call (``host_us``: CALLS calls
queued back to back on the host's clock, the wait for the card after the
clock stops) and of its input checks alone (``check_us``).  Where one
PyTorch call computes the same function (``torch._grouped_mm``; SDPA for
the (10, 1, 256) decodes), its queued time is read beside (``library``).

A reading is the median of REPEATS launches.  The script prints the
card's name and power limit, one JSON line per process, a summary line
per kernel, checkout and timer (each checkout's median over A's), and
last a JSON object with every reading.  It exits non-zero without a card
or when a process fails.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

H, KV, D, BS = 14, 2, 64, 16
# recurrentgemma-2b's and deepseek-v2-lite's rows, as chip_smoke.py builds
# them (its RG_PRE_ROWS, RG_TABLE_W, DS_ROW_OFFSETS, DS_TABLE_W)
RG_H, RG_KV, RG_D, RG_WINDOW = 10, 1, 256, 2048
RG_PRE_ROWS = ((0, 900), (1792, 2900), (2304, 3000), (0, 0))
RG_TABLE_W, RG_BLOCKS = 194, 4096
DS_H, DS_DK, DS_DV = 16, 192, 128
DS_ROW_OFFSETS, DS_KEYS = (0, 256, 768, 1280), 96 * BS
# deepseek-v2-lite-16b's routed experts, as chip_smoke.py draws them
DS_E, DS_TOPK, DS_MODEL, DS_FF = 64, 6, 2048, 1408
GM_ROWS = {"decode": 16 * DS_TOPK, "prefill": 4 * 256 * DS_TOPK}
# the grouped matmul backward's rows: deepseek-v2-lite's train step (2 x
# 4096 tokens) and its RL update (1 x 4 samples of 64 + 32 tokens)
GM_BWD_ROWS = {"train": 2 * 4096 * DS_TOPK, "rl": 4 * (64 + 32) * DS_TOPK}
# deepseek-v2-lite's MLA decode and mamba2-370m's SSD scan, as chip_smoke.py
# draws them (its mla_inputs and ssd_inputs, seeds SEED + 6, + 20, + 21)
DS_R, DS_ROPE, DS_BLOCKS, DS_TABLE_W = 512, 64, 2048, 96
DS_LENGTHS = (100, 1500 + 32)
SSM_H, SSM_P, SSM_N, SSM_Q = 32, 64, 128, 256
SSM_ROWS = ((0, 900), (768, 1400), (1280, 1400), (0, 0))
# recurrentgemma-2b's paged decode and RG-LRU scan, as chip_smoke.py draws
# them (its rg_cases and rg_scan_inputs: seeds SEED + 40, + 30, + 31)
RG_W, RG_LENGTHS, RG_LONG = 2560, (100, 3000 + 64), 4
# qwen2-0.5b's train step (chip_smoke.py's TRAIN_B x TRAIN_S): flash's
# backward; and the backward at the wider heads (chip_smoke.py's BWD_WIDE)
TRAIN_B, TRAIN_S = 4, 4096
BWD_WIDE, BWD_WIDE_B, BWD_WIDE_S = (24, 8, 128), 2, 2048
# deepseek-v2-lite's train step (chip_smoke.py's BWD_MLA, DS_TRAIN_B x
# DS_TRAIN_S): (H, KV, Dk, Dv)
BWD_MLA, BWD_MLA_B, BWD_MLA_S = (16, 16, 192, 128), 2, 4096
# the wrappers' input checks where a module's is not ``_check``
CHECKS = {"paged_mla_decode_attention": "_mla_check",
          "flash_attention_bwd": "_bwd_check",
          "grouped_matmul_bwd_dx": "_bwd_inputs",
          "grouped_matmul_bwd_dw": "_bwd_inputs"}
# recurrentgemma-2b's and mamba2-370m's train steps (chip_smoke.py's
# RG_TRAIN_B x RG_TRAIN_S and SSM_TRAIN_B x SSM_TRAIN_S): flash's backward
# at (256, 256), G = 10, windowed; the two scans' backwards
RG_TRAIN_B, RG_TRAIN_S, SSM_TRAIN_B, SSM_TRAIN_S = 1, 4096, 4, 4096
# the source of a kernel whose wrapper is not named after it
SOURCES = {"grouped_matmul_bwd_dx": "grouped_matmul_bwd",
           "grouped_matmul_bwd_dw": "grouped_matmul_bwd"}
# the sources whose ptxas report (registers, spill stores) each tree prints
PTXAS = ("flash_attention", "ragged_prefill_attention", "flash_attention_bwd",
         "ssd_scan_bwd", "rglru_scan_bwd", "grouped_matmul",
         "grouped_matmul_bwd")
ROUNDS = 5
REPEATS = 30
CALLS = 200
PARITY = 2.0 ** -6     # x max(1, max |out|): a bf16 step below 2; the parity
                       # of chip_smoke.py is stricter; this only shows the
                       # kernel ran and is sane


SLEEP_CYCLES = 500_000   # ~0.3 ms of the card's clock: more than a call's
                         # host time


def timer_queued(fn, torch, repeats=REPEATS):
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(repeats)]
    for t0, t1 in events:
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0.record()
        fn()
        t1.record()
    events[-1][1].synchronize()
    times = sorted(t0.elapsed_time(t1) for t0, t1 in events)
    return times[len(times) // 2]


def timer_synced(fn, torch, repeats=REPEATS):
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()
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


def host_us(fn, torch, calls=CALLS):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


TIMERS = (("queued", timer_queued), ("synced", timer_synced))
MEASURES = ("queued", "synced", "host_us", "check_us", "library")
SPLIT_CALLS = 10     # calls of a backward under the profiler, for its split


def kernel_split(fn, torch, calls=SPLIT_CALLS):
    """Device ms a call of each kernel that one wrapper call launches (a
    backward launches several), from torch.profiler's CUDA activity over
    ``calls`` calls, each behind a cold-L2 flush: {kernel name: ms a
    call}.  The repository's kernels are the ones in an anonymous
    namespace (every csrc/*.cu keeps its kernels in one), which leaves
    the flush's own kernel out."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()
    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0 and "(anonymous namespace)" in e.key:
            out[e.key] = out.get(e.key, 0.0) + t / 1e3 / calls
    return out


def rg_table(torch, g, limits, window):
    """Block tables as the recurrentgemma scheduler leaves them: each block
    drawn once, the entries wholly below the window null (block 0)."""
    perm = torch.randperm(RG_BLOCKS - 1, generator=g) + 1
    tables = torch.zeros(len(limits), RG_TABLE_W, dtype=torch.int32)
    used = 0
    for r, n in enumerate(limits):
        nb, freed = -(-n // BS), max(0, n - window) // BS
        tables[r, freed:nb] = perm[used:used + nb - freed]
        used += nb - freed
    return tables


def sdpa_dense_decode(torch, q, k, v, lengths):
    """One SDPA call with a length mask (the GQA head expansion and the
    layout changes outside the call), as chip_smoke.py's yardstick."""
    mask = (torch.arange(k.shape[1], device=q.device)[None, :]
            < lengths[:, None])
    return sdpa_masked_decode(torch, q, k, v, mask)


def sdpa_masked_decode(torch, q, k, v, mask):
    """One SDPA call of q (B, 1, H, D) over k, v (B, S, KV, D) under a
    boolean (B, S) mask (the GQA head expansion, the layout changes and
    the mask outside the call)."""
    import torch.nn.functional as F
    G = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(G, 2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(G, 2).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(
        qh, k, v, attn_mask=mask[:, None, None, :])


def train_cases(torch):
    """Flash's backward at qwen2-0.5b's train shape (B = 4, S = 4096,
    (14, 2, 64), causal), at the wide heads of phi4-mini, llama3-8b and
    granite ((24, 8, 128), BWD_WIDE_B x BWD_WIDE_S, causal) and, in trees
    whose backward takes (192, 128), at deepseek-v2-lite's train shape
    (BWD_MLA: "flash_attention_bwd mla"), its inputs the forward kernel's
    output and lse on q, k, v drawn from a seed, beside SDPA's backward
    (autograd through SDPA less SDPA's forward).  None for a tree without
    the backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    if not hasattr(fa, "flash_attention_bwd"):
        return {}
    out = {}
    shapes = [("flash_attention_bwd train", (H, KV, D, D), TRAIN_B, TRAIN_S),
              ("flash_attention_bwd wide", BWD_WIDE + BWD_WIDE[2:],
               BWD_WIDE_B, BWD_WIDE_S)]
    if tuple(BWD_MLA[2:]) in getattr(fa, "BWD_PAIRS", ()):
        shapes.append(("flash_attention_bwd mla", BWD_MLA, BWD_MLA_B,
                       BWD_MLA_S))
    if (RG_D, RG_D) in getattr(fa, "BWD_PAIRS", ()):
        shapes.append(("flash_attention_bwd d256 g10",
                       (RG_H, RG_KV, RG_D, RG_D), RG_TRAIN_B, RG_TRAIN_S))
    for case, (heads, kv, dk, dv), batch, seq in shapes:
        window = RG_WINDOW if case.endswith("d256 g10") else None
        g = torch.Generator(device="cpu").manual_seed(50)
        q, k, v, do = (torch.randn(batch, seq, n, dim, generator=g)
                       .to("cuda", torch.bfloat16)
                       for n, dim in ((heads, dk), (kv, dk), (kv, dv),
                                      (heads, dv)))
        o, lse = fa.flash_attention_lse(q, k, v, causal=True, window=window)
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        doh = do.transpose(1, 2).contiguous()
        pos = torch.arange(seq, device="cuda")
        mask = None if window is None else (
            (pos[None, :] <= pos[:, None])
            & (pos[:, None] - pos[None, :] < window))

        def fwd(qh=qh, kh=kh, vh=vh, mask=mask):
            if mask is not None:
                return F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, enable_gqa=True)
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                  enable_gqa=True)
        args = (q, k, v, o, lse, do)
        out[case] = (fa, "flash_attention_bwd", args,
                     dict(causal=True, window=window), args,
                     (lambda fwd=fwd, qh=qh, kh=kh, vh=vh, doh=doh:
                      torch.autograd.grad(fwd(), (qh, kh, vh), doh), fwd))
    return out


def scan_bwd_cases(torch):
    """The two scans' backwards at the train steps' shapes, in trees that
    have them: ssd_scan_bwd at mamba2-370m's (SSM_TRAIN_B x SSM_TRAIN_S,
    chunks of 256, x, B and C column slices of one tensor, dfin None) and
    rglru_scan_bwd at recurrentgemma-2b's (RG_TRAIN_B x RG_TRAIN_S x
    2560), drawn as chip_smoke.py's ssd_bwd_cases and rg_bwd_cases draw
    them (seeds SEED + 60, + 62).  No PyTorch call computes either."""
    import torch.nn.functional as F
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssd_scan as ss
    out = {}
    if hasattr(ss, "ssd_scan_bwd"):
        di = SSM_H * SSM_P
        B, S = SSM_TRAIN_B, SSM_TRAIN_S
        g = torch.Generator(device="cpu").manual_seed(60)
        xbc = (torch.randn(B, S, di + 2 * SSM_N, generator=g) * 0.3).to(
            "cuda", torch.bfloat16)
        x = xbc[..., :di].reshape(B, S, SSM_H, SSM_P)
        dt = F.softplus(torch.randn(B, S, SSM_H, generator=g)).to("cuda")
        A = -torch.exp(torch.randn(SSM_H, generator=g) * 0.3).to("cuda")
        g = torch.Generator(device="cpu").manual_seed(160)
        dy = torch.randn(B, S, SSM_H, SSM_P, generator=g).to(
            "cuda", torch.bfloat16)
        args = (x, dt, A, xbc[..., di:di + SSM_N], xbc[..., di + SSM_N:],
                dy, None)
        out["ssd_scan_bwd train"] = (
            ss, "ssd_scan_bwd", args, dict(chunk=SSM_Q, init_state=None),
            (*args[:5], SSM_Q, None), None)
    if hasattr(rs, "rglru_scan_bwd"):
        B, S = RG_TRAIN_B, RG_TRAIN_S
        g = torch.Generator(device="cpu").manual_seed(62)
        x = torch.randn(B, S, RG_W, generator=g) * 0.5
        ig = torch.sigmoid(torch.randn(B, S, RG_W, generator=g))
        ag = torch.sigmoid(torch.randn(B, S, RG_W, generator=g))
        la = -F.softplus(-torch.linspace(2.0, 6.0, RG_W)).to("cuda")
        g = torch.Generator(device="cpu").manual_seed(162)
        dh = torch.randn(B, S, RG_W, generator=g)
        args = tuple(t.to("cuda", torch.bfloat16) for t in (x, ig, ag)) + (
            la, dh.to("cuda", torch.bfloat16), None)
        out["rglru_scan_bwd train"] = (
            rs, "rglru_scan_bwd", args, dict(init_state=None),
            (*args[:4], None), None)
    return out


def ptxas_rows(logs):
    """[(kernel instantiation, registers, spill-store bytes)] of ``nvcc
    -Xptxas -v`` logs, the names demangled as far as c++filt goes."""
    import re
    rows, fn = [], None
    for text in logs.values():
        spill = 0
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn, spill = m.group(1), 0
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                rows.append([fn, int(m.group(1)), spill])
                fn = None
    return rows


def gm_cases(torch, g):
    """The grouped matmul's five cases: expert-sorted rows, the model's
    init scale, each of rows / top_k tokens routed to top_k distinct
    experts drawn uniformly, or every row in one expert."""
    from repro_torch.kernels import grouped_matmul as gm
    scale = (2.0 / (DS_MODEL + DS_FF)) ** 0.5
    w = {(DS_MODEL, DS_FF): (torch.randn(DS_E, DS_MODEL, DS_FF, generator=g)
                             * scale).to("cuda", torch.bfloat16)}
    w[(DS_FF, DS_MODEL)] = (torch.randn(DS_E, DS_FF, DS_MODEL, generator=g)
                            * scale).to("cuda", torch.bfloat16)
    out = {}
    for case, rows, dims, one in (
            ("decode w_gate/w_up", GM_ROWS["decode"], (DS_MODEL, DS_FF), 0),
            ("decode w_down", GM_ROWS["decode"], (DS_FF, DS_MODEL), 0),
            ("prefill w_gate/w_up", GM_ROWS["prefill"], (DS_MODEL, DS_FF), 0),
            ("prefill w_down", GM_ROWS["prefill"], (DS_FF, DS_MODEL), 0),
            ("prefill, one expert", GM_ROWS["prefill"], (DS_MODEL, DS_FF),
             1)):
        if one:
            sizes = torch.zeros(DS_E, dtype=torch.int32)
            sizes[DS_E // 2] = rows
        else:
            picks = torch.rand(rows // DS_TOPK, DS_E, generator=g).topk(
                DS_TOPK, dim=-1).indices
            sizes = torch.bincount(picks.reshape(-1), minlength=DS_E)
        sizes = sizes.to("cuda", torch.int32)
        x = torch.randn(rows, dims[0], generator=g).to("cuda", torch.bfloat16)
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        lib = None
        if hasattr(torch, "_grouped_mm"):
            lib = functools.partial(torch._grouped_mm, x, w[dims], offs=offs)
        out[f"grouped_matmul {case}"] = (gm, "grouped_matmul",
                                         (x, w[dims], sizes), {},
                                         (x, w[dims], sizes), lib)
    return out


def gm_bwd_cases(torch, g):
    """The grouped matmul backward's cases, in trees whose wrapper has
    grouped_matmul_bwd_dx: dx and dw at deepseek-v2-lite's train shape
    ("grouped_matmul_bwd train": GM_BWD_ROWS["train"], chip_smoke.py's
    DS_TRAIN_B x DS_TRAIN_S tokens x top-6) and at its RL update's
    ("grouped_matmul_bwd rl": chip_smoke.py's DS_RL_PROMPTS x DS_RL_GROUP
    samples of DS_RL_PROMPT_LEN + DS_RL_NEW tokens x top-6), each for the
    w_gate/w_up (2048 -> 1408) and w_down (1408 -> 2048) shapes: rows
    routed as gm_cases routes them, x and w at the model's init scale, dy
    at 0.01 (chip_smoke.py's grouped_bwd_cases).  The library call is one
    torch._grouped_mm for the same product: (dy, w^T) for dx and (x^T,
    dy) with the group sizes splitting the summed rows for dw; each case
    carries its bound (perf_model.grouped_matmul_bwd_cost)."""
    from repro_torch.kernels import grouped_matmul as gm
    out = {}
    if not hasattr(gm, "grouped_matmul_bwd_dx"):
        return out
    scale = (2.0 / (DS_MODEL + DS_FF)) ** 0.5
    for run, rows in GM_BWD_ROWS.items():
        for shape, (d, f) in (("w_gate/w_up", (DS_MODEL, DS_FF)),
                              ("w_down", (DS_FF, DS_MODEL))):
            picks = torch.rand(rows // DS_TOPK, DS_E, generator=g).topk(
                DS_TOPK, dim=-1).indices
            sizes = torch.bincount(picks.reshape(-1), minlength=DS_E).to(
                "cuda", torch.int32)
            x = torch.randn(rows, d, generator=g).to("cuda", torch.bfloat16)
            w = (torch.randn(DS_E, d, f, generator=g) * scale).to(
                "cuda", torch.bfloat16)
            dy = (torch.randn(rows, f, generator=g) * 0.01).to(
                "cuda", torch.bfloat16)
            offs = torch.cumsum(sizes, 0, dtype=torch.int32)
            has = hasattr(torch, "_grouped_mm")
            for part, args, lib in (
                    ("dx", (dy, w, sizes), has and functools.partial(
                        torch._grouped_mm, dy, w.transpose(1, 2),
                        offs=offs)),
                    ("dw", (x, dy, sizes), has and functools.partial(
                        torch._grouped_mm, x.t(), dy, offs=offs))):
                name = f"grouped_matmul_bwd_{part}"
                # the wrapper's checks: (a, dy) is (dy, dy) for dx
                check = (name, args[0], dy, sizes, d, f, DS_E)
                out[f"grouped_matmul_bwd {run} {shape} {part}"] = (
                    gm, name, args, {}, check, lib or None,
                    (part, sizes.tolist(), d, f))
    return out


def bwd_bound_ms(part, sizes, d, f):
    """perf_model.grouped_matmul_bwd_cost's bound (bf16), ms."""
    from repro_torch.kernels import perf_model as pm
    return pm.grouped_matmul_bwd_cost(
        sizes, d_in=d, d_out=f, itemsize=2,
        part=part).bound_seconds("bfloat16") * 1e3


def mla_case(torch):
    """The deepseek serving decode's MLA inputs (chip_smoke.mla_inputs)."""
    from repro_torch.kernels import paged_decode_attention as pda
    g = torch.Generator(device="cpu").manual_seed(6)
    lengths = torch.randint(DS_LENGTHS[0], DS_LENGTHS[1] + 1, (16,),
                            generator=g)
    perm = torch.randperm(DS_BLOCKS - 1, generator=g) + 1
    tables = torch.zeros(16, DS_TABLE_W, dtype=torch.int32)
    used = 0
    for b in range(16):
        n = -(-int(lengths[b]) // BS)
        tables[b, :n] = perm[used:used + n]
        used += n
    arrays = [torch.randn(*s, generator=g).to("cuda", torch.bfloat16)
              for s in ((16, DS_H, DS_R), (16, DS_H, DS_ROPE),
                        (DS_BLOCKS, BS, DS_R), (DS_BLOCKS, BS, DS_ROPE))]
    args = (*arrays, tables.to("cuda"), lengths.to("cuda", torch.int32))
    return {"paged_mla_decode_attention": (
        pda, "paged_mla_decode_attention", args,
        dict(block_size=BS, scale=(128 + DS_ROPE) ** -0.5),
        (*args, BS), None)}


def ssd_cases(torch):
    """ssd_scan at the serving prefill call and the Generator prefill
    (chip_smoke.ssd_inputs)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_scan as ss
    di = SSM_H * SSM_P
    out = {}
    for case, rows, S, seed, serving in (
            ("ssd_scan serving prefill", 4, 256, 20, True),
            ("ssd_scan Generator prefill", 8, 1024, 21, False)):
        g = torch.Generator(device="cpu").manual_seed(seed)
        xbc = (torch.randn(rows, S, di + 2 * SSM_N, generator=g) * 0.3).to(
            "cuda", torch.bfloat16)
        x = xbc[..., :di].reshape(rows, S, SSM_H, SSM_P)
        dt = F.softplus(torch.randn(rows, S, SSM_H, generator=g))
        A = -torch.exp(torch.randn(SSM_H, generator=g) * 0.3)
        init = None
        if serving:
            starts = torch.tensor([r[0] for r in SSM_ROWS])
            limits = torch.tensor([r[1] for r in SSM_ROWS])
            pos = starts[:, None] + torch.arange(S)[None, :]
            dt = dt * (pos < limits[:, None])[..., None]
            init = torch.randn(rows, SSM_H, SSM_P, SSM_N, generator=g)
            init[limits == 0] = 0.0
            init = init.to("cuda", torch.bfloat16)
        args = (x, dt.to("cuda"), A.to("cuda"), xbc[..., di:di + SSM_N],
                xbc[..., di + SSM_N:])
        out[case] = (ss, "ssd_scan", args,
                     dict(chunk=SSM_Q, init_state=init),
                     (*args, SSM_Q, init), None)
    return out


def rg_cases(torch):
    """The recurrentgemma serving decode's paged decode inputs
    (chip_smoke.rg_cases) and rglru_scan at its serving prefill call and
    Generator prefill (chip_smoke.rg_scan_inputs)."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import rglru_scan as rs
    out = {}
    for case, rows, S, seed, serving in (
            ("rglru_scan serving", 4, 256, 30, True),
            ("rglru_scan generator", 8, 1024, 31, False)):
        g = torch.Generator(device="cpu").manual_seed(seed)
        x = torch.randn(rows, S, RG_W, generator=g) * 0.5
        ig = torch.sigmoid(torch.randn(rows, S, RG_W, generator=g))
        ag = torch.sigmoid(torch.randn(rows, S, RG_W, generator=g))
        la = -F.softplus(-torch.linspace(2.0, 6.0, RG_W)).to("cuda")
        init = None
        if serving:
            starts = torch.tensor([r[0] for r in SSM_ROWS])
            limits = torch.tensor([r[1] for r in SSM_ROWS])
            pos = starts[:, None] + torch.arange(S)[None, :]
            ag = ag * (pos < limits[:, None])[..., None]
            init = torch.randn(rows, RG_W, generator=g)
            init[limits == 0] = 0.0
            init = init.to("cuda", torch.bfloat16)
        args = tuple(t.to("cuda", torch.bfloat16) for t in (x, ig, ag)) + (
            la,)
        out[case] = (rs, "rglru_scan", args, dict(init_state=init),
                     (*args, init), None)
    g = torch.Generator(device="cpu").manual_seed(40)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to("cuda", torch.bfloat16)
    k_pool, v_pool = (rnd(RG_BLOCKS, BS, RG_KV, RG_D) for _ in range(2))
    lengths = torch.randint(RG_LENGTHS[0], RG_LENGTHS[1] + 1, (16,),
                            generator=g)
    top = RG_LENGTHS[1]
    lengths[:RG_LONG] = torch.tensor([RG_WINDOW + 1, RG_WINDOW + BS,
                                      (RG_WINDOW + top) // 2, top])
    tables = rg_table(torch, g, lengths.tolist(), RG_WINDOW)
    q = rnd(16, 1, RG_H, RG_D)
    lens = lengths.to("cuda", torch.int32)
    args = (q, k_pool, v_pool, tables.to("cuda"), lens)
    S = RG_TABLE_W * BS
    pos = torch.arange(S, device="cuda")[None, :]
    mask = (pos < lens[:, None]) & (pos >= lens[:, None] - RG_WINDOW)
    idx = tables.to("cuda").long()
    k = k_pool[idx].reshape(16, S, RG_KV, RG_D)
    v = v_pool[idx].reshape(16, S, RG_KV, RG_D)
    out["paged_decode_attention d256 g10"] = (
        pda, "paged_decode_attention", args,
        dict(block_size=BS, window=RG_WINDOW), (q, k_pool, v_pool),
        sdpa_masked_decode(torch, q, k, v, mask))
    return out


def cases(torch):
    """{case: (module, kernel, wrapper args, kwargs, check args, library
    call or None, bound's (part, sizes, d, f) or None)}, the same inputs
    in every process (drawn on the host from fixed seeds); a case left
    without the last items gets None for them."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import ragged_prefill_attention as rpa
    g = torch.Generator(device="cpu").manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to("cuda", torch.bfloat16)

    def ints(t):
        return t.to("cuda", torch.int32)
    q, k, v = rnd(8, 1024, H, D), rnd(8, 1024, KV, D), rnd(8, 1024, KV, D)
    out = {"flash_attention": (fa, "flash_attention", (q, k, v),
                               dict(causal=True), (q, k, v, 0))}
    q, k, v = rnd(8, 1, H, D), rnd(8, 1096, KV, D), rnd(8, 1096, KV, D)
    lens = ints(torch.randint(1025, 1088, (8,), generator=g))
    out["decode_attention"] = (da, "decode_attention", (q, k, v, lens), {},
                               (q, k, v, lens))
    nb, width = 2048, 128
    k_pool, v_pool = rnd(nb, BS, KV, D), rnd(nb, BS, KV, D)
    perm = torch.randperm(nb - 1, generator=g) + 1
    lengths = torch.randint(100, 1565, (16,), generator=g)
    tables = torch.zeros(16, width, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths.tolist()):
        nbk = -(-n // BS)
        tables[b, :nbk] = perm[used:used + nbk]
        used += nbk
    q = rnd(16, 1, H, D)
    out["paged_decode_attention"] = (
        pda, "paged_decode_attention",
        (q, k_pool, v_pool, ints(tables), ints(lengths)),
        dict(block_size=BS), (q, k_pool, v_pool))
    starts = ints(torch.tensor([0, 768, 1280, 0]))
    limits = ints(torch.tensor([900, 1400, 1400, 0]))
    q = rnd(4, 256, H, D)
    out["ragged_prefill_attention"] = (
        rpa, "ragged_prefill_attention",
        (q, k_pool, v_pool, ints(tables[:4]), starts, limits),
        dict(block_size=BS), (q, k_pool, v_pool))
    # recurrentgemma-2b: the ragged prefill over RG_PRE_ROWS, flash 8 x 1024
    k_pool, v_pool = (rnd(RG_BLOCKS, BS, RG_KV, RG_D) for _ in range(2))
    tables = rg_table(torch, g, [min(lim, st + 256) for st, lim in
                                 RG_PRE_ROWS], RG_WINDOW + 256)
    q = rnd(4, 256, RG_H, RG_D)
    rows = (ints(torch.tensor([r[0] for r in RG_PRE_ROWS])),
            ints(torch.tensor([r[1] for r in RG_PRE_ROWS])))
    out["ragged_prefill_attention d256 g10"] = (
        rpa, "ragged_prefill_attention",
        (q, k_pool, v_pool, ints(tables), *rows),
        dict(block_size=BS, window=RG_WINDOW), (q, k_pool, v_pool))
    q, k, v = (rnd(8, 1024, n, RG_D) for n in (RG_H, RG_KV, RG_KV))
    out["flash_attention d256 g10"] = (
        fa, "flash_attention", (q, k, v),
        dict(causal=True, window=RG_WINDOW), (q, k, v, 0))
    # deepseek-v2-lite: its prefill call's flash rows, (Dk, Dv) = (192, 128)
    q = rnd(4, 256, DS_H, DS_DK)
    k, v = rnd(4, DS_KEYS, DS_H, DS_DK), rnd(4, DS_KEYS, DS_H, DS_DV)
    offs = ints(torch.tensor(DS_ROW_OFFSETS))
    out["flash_attention dk192 dv128"] = (
        fa, "flash_attention", (q, k, v),
        dict(causal=True, q_offset=offs, scale=DS_DK ** -0.5),
        (q, k, v, offs))
    # recurrentgemma-2b's Generator decode: 8 rows over 1096 entries
    q = rnd(8, 1, RG_H, RG_D)
    k, v = rnd(8, 1096, RG_KV, RG_D), rnd(8, 1096, RG_KV, RG_D)
    lens = ints(torch.randint(1025, 1088, (8,), generator=g))
    out["decode_attention d256 g10"] = (
        da, "decode_attention", (q, k, v, lens), {}, (q, k, v, lens),
        sdpa_dense_decode(torch, q, k, v, lens))
    out.update(gm_cases(torch, g))
    out.update(gm_bwd_cases(torch, g))
    out.update(mla_case(torch))
    out.update(ssd_cases(torch))
    out.update(rg_cases(torch))
    out.update(train_cases(torch))
    out.update(scan_bwd_cases(torch))
    return {c: t + (None,) * (7 - len(t)) for c, t in out.items()}


def worker(tree: str, only) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.kernels import build
    result = {"tree": tree, "ptxas": ptxas_rows(build.build(
        [n for n in PTXAS if (build.CSRC / f"{n}.cu").exists()]))}
    for case, (mod, name, args, kw, check, lib, bound) in \
            cases(torch).items():
        if only and not case.startswith(tuple(only)):
            continue
        fn, ref = getattr(mod, name), getattr(mod, f"{name}_ref")
        before = fn.launches
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        if fn.launches != before + 1:
            raise AssertionError(f"{tree}: {case} launched no kernel")
        want = ref(*args, **kw)
        if not isinstance(got, tuple):            # ssd_scan: (y, state)
            got, want = (got,), (want,)
        errs = []
        for g, w in zip(got, want):
            if g is None:                         # no initial state
                continue
            errs.append((g.float() - w.float()).abs().max().item())
            limit = PARITY * max(1.0, w.float().abs().max().item())
            if not errs[-1] <= limit:
                raise AssertionError(f"{tree}: {case} max abs error "
                                     f"{errs[-1]} > {limit}")
        err = max(errs)
        readings = {m: [] for m in MEASURES if m != "library" or lib}
        for _ in range(ROUNDS):
            for m, timer in TIMERS:
                readings[m].append(timer(lambda: fn(*args, **kw), torch))
            readings["host_us"].append(host_us(lambda: fn(*args, **kw),
                                               torch))
            check_fn = getattr(mod, CHECKS.get(name, "_check"))
            readings["check_us"].append(host_us(lambda: check_fn(*check),
                                                torch))
            if isinstance(lib, tuple):   # (with the part to take away, part)
                readings["library"].append(timer_queued(lib[0], torch)
                                           - timer_queued(lib[1], torch))
            elif lib is not None:
                readings["library"].append(timer_queued(lib, torch))
        result[case] = {"lib": build.lib_path(SOURCES.get(name, name)).name,
                        "max_abs_err": err, **readings}
        if bound is not None:            # (part, sizes, d, f)
            result[case]["bound_ms"] = bwd_bound_ms(*bound)
        if name.endswith("_bwd"):        # its time split by kernel
            result[case]["kernels"] = kernel_split(lambda: fn(*args, **kw),
                                                   torch)
    print(json.dumps(result))


def main(trees, only) -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    runs = []
    for tree in trees + trees[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", tree, *only],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            out.check_returncode()
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for tree in trees:                 # each tree's build, once
        run = next(r for r in runs if r["tree"] == tree)
        for fn, regs, spill in run["ptxas"]:
            print(f"ptxas {tree}: {fn}: {regs} registers, {spill} bytes "
                  "spill stores")
    kernels = [k for r in runs for k in r if k not in ("tree", "ptxas")]
    for kernel in dict.fromkeys(kernels):
        have = [t for t in trees if kernel in next(
            r for r in runs if r["tree"] == t)]
        first = next(r for r in runs if kernel in r)
        for name in [m for m in MEASURES if m in first[kernel]]:
            med = {}
            for tree in have:
                vals = sorted(x for r in runs if r["tree"] == tree
                              for x in r[kernel][name])
                med[tree] = vals[len(vals) // 2]
                unit = "us" if name.endswith("_us") else "ms"
                print(f"{kernel} {name} {tree}: median {med[tree]:.4f} "
                      f"{unit}, range {vals[0]:.4f}..{vals[-1]:.4f} {unit} "
                      f"over {len(vals)} readings")
            for tree in have[1:]:
                print(f"{kernel} {name}: {tree} / {have[0]} = "
                      f"{med[tree] / med[have[0]]:.4f}")
        if "bound_ms" in first[kernel]:
            print(f"{kernel} bound: {first[kernel]['bound_ms']:.5f} ms "
                  "(perf_model.grouped_matmul_bwd_cost, bf16 peaks)")
        for tree in have:                # a backward's split by kernel
            splits = [r[kernel]["kernels"] for r in runs
                      if r["tree"] == tree and "kernels" in r[kernel]]
            for fn in dict.fromkeys(k for sp in splits for k in sp):
                vals = sorted(sp.get(fn, 0.0) for sp in splits)
                print(f"{kernel} kernel {tree}: {fn}: median "
                      f"{vals[len(vals) // 2]:.4f} ms a call, range "
                      f"{vals[0]:.4f}..{vals[-1]:.4f} over {len(vals)} "
                      "processes (profiler)")
    print(json.dumps({"shape": [H, KV, D], "runs": runs}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    dirs = [a for a in sys.argv[1:] if os.path.isdir(a)]
    if len(dirs) < 2:
        sys.exit(__doc__)
    sys.exit(main(dirs, [a for a in sys.argv[1:] if a not in dirs]))
