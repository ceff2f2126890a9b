#!/usr/bin/env python3
"""Time the flash_attention kernel of two checkouts of this repository on
one NVIDIA card, each checkout in its own process, in the order A, B, B, A.

    python3 kernel_ab.py A_DIR B_DIR     # two unpacked checkouts, A first

Each process builds its checkout's flash kernel (into that checkout's
``build/``), holds it against that checkout's plain version, and times it
through the checkout's wrapper at the Generator prefill shape of
``chip_smoke.py`` (qwen2-0.5b: B=8, S=1024, H=14, KV=2, D=64, bf16,
causal) with two timers, ROUNDS readings each:

* queued -- every launch queued behind a cold-L2 flush and one wait at
  the end (the ``time_ms`` of ``chip_smoke.py``);
* synced -- a wait after every launch, so host time that the card does
  not hide is counted too (the timer ``chip_smoke.py`` had before);

and the host's own time of one wrapper call (``host_us``: CALLS calls
queued back to back on the host's clock, the wait for the card after the
clock stops) and of its input checks alone (``check_us``).

A reading is the median of REPEATS launches.  The script prints the
card's name and power limit, one JSON line per process, a summary line
per checkout and timer, and last a JSON object with every reading.  It
exits non-zero without a card or when a process fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

B, S, H, KV, D = 8, 1024, 14, 2, 64
ROUNDS = 5
REPEATS = 30
CALLS = 200
PARITY = 2.0 ** -6     # a bf16 step at |out| < 2: the parity of chip_smoke.py
                       # is stricter; this only shows the kernel ran and is sane


def timer_queued(fn, torch, repeats=REPEATS):
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(repeats)]
    for t0, t1 in events:
        flush.zero_()
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
MEASURES = ("queued", "synced", "host_us", "check_us")


def worker(tree: str) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(3)
    q, k, v = (torch.randn(B, S, n, D, generator=g).to("cuda", torch.bfloat16)
               for n in (H, KV, KV))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    if fa.flash_attention.launches != before + 1:
        raise AssertionError(f"{tree}: the wrapper launched no kernel")
    err = (got.float() - fa.flash_attention_ref(q, k, v, causal=True).float()
           ).abs().max().item()
    if not err <= PARITY:
        raise AssertionError(f"{tree}: max abs error {err} > {PARITY}")
    readings = {name: [] for name in MEASURES}
    for _ in range(ROUNDS):
        for name, timer in TIMERS:
            readings[name].append(timer(
                lambda: fa.flash_attention(q, k, v, causal=True), torch))
        readings["host_us"].append(host_us(
            lambda: fa.flash_attention(q, k, v, causal=True), torch))
        readings["check_us"].append(host_us(
            lambda: fa._check(q, k, v, 0), torch))
    print(json.dumps({"tree": tree, "lib": build.lib_path(
        "flash_attention").name, "max_abs_err": err, **readings}))


def main(a: str, b: str) -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    runs = []
    for tree in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", tree], check=True,
                             capture_output=True, text=True, timeout=900)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for name in MEASURES:
        med = {}
        for tree in (a, b):
            vals = sorted(x for r in runs if r["tree"] == tree
                          for x in r[name])
            med[tree] = vals[len(vals) // 2]
            unit = "us" if name.endswith("_us") else "ms"
            print(f"{name} {tree}: median {med[tree]:.4f} {unit}, range "
                  f"{vals[0]:.4f}..{vals[-1]:.4f} {unit} over {len(vals)} "
                  "readings")
        print(f"{name}: B / A = {med[b] / med[a]:.4f}")
    print(json.dumps({"shape": [B, S, H, KV, D], "runs": runs}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
