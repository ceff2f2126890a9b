#!/usr/bin/env python3
"""Peak device memory of an arch's bf16 train step at full width, at one
or more depths, each depth in a process of its own.

    python3 train_depth.py [--batch ROWS] ARCH LAYERS [LAYERS ...]

Each depth runs ``chip_smoke.phase_train`` for STEPS steps of ROWS x SEQ
tokens (ROWS: BATCH unless ``--batch`` is given), the shape of
chip_smoke.py's deepseek-v2-lite and musicgen-large train phases (ROWS = 2)
and of its recurrentgemma-2b phase (ROWS = 1) (random weights from a seed,
the reference's synthetic
corpus, an arch with a multimodal frontend after its seeded prefix; the
launch and finiteness checks) and prints its log, the peak of
``torch.cuda.max_memory_allocated`` included, under the caching
allocator's defaults (as ``python -m repro_torch.launch.train`` runs).  A depth that runs out of
device memory prints "out of memory" and the next depth still runs.
Needs one CUDA card; the kernels build at first use.
"""
from __future__ import annotations

import subprocess
import sys

BATCH, SEQ, STEPS = 2, 4096, 3


def one(arch: str, layers: int, batch: int) -> int:
    import numpy as np
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("train_depth: no CUDA device", file=sys.stderr)
        return 1
    tag = f"{arch} {layers} layers, {batch} x {SEQ}"
    try:
        chip_smoke.phase_train(torch, np, arch, layers, batch, SEQ, STEPS,
                               tag)
    except torch.cuda.OutOfMemoryError as e:
        print(f"[{tag}] out of memory: {str(e).splitlines()[0]}", flush=True)
        return 3
    return 0


def main(argv) -> int:
    if len(argv) == 4 and argv[0] == "--one":
        return one(argv[1], int(argv[2]), int(argv[3]))
    batch = BATCH
    if len(argv) >= 2 and argv[0] == "--batch":
        batch, argv = int(argv[1]), argv[2:]
    if len(argv) < 2:
        print("usage: train_depth.py [--batch ROWS] ARCH LAYERS "
              "[LAYERS ...]", file=sys.stderr)
        return 2
    rc = 0
    for n in argv[1:]:
        r = subprocess.run([sys.executable, __file__, "--one", argv[0],
                            str(int(n)), str(batch)]).returncode
        if r not in (0, 3):
            rc = r
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
