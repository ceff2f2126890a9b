"""Package-level contract of the port.

- ``repro_torch`` and every submodule, HyperRL's ``repro_torch.rl`` and
  its launcher and HyperMPMD's ``repro_torch.core.mpmd`` among them,
  import without JAX and without anything of the
  reference package ``repro`` (checked in a fresh interpreter, where
  nothing else could have imported them);
- the serving entry points (``HyperServe``, ``ServeEngine``,
  ``Generator``, the launcher) run on the card unless the caller names
  ``device="cpu"``: with no CUDA device and no device named they raise,
  they never fall back to the CPU;
- ``chip_smoke.py`` exits non-zero and prints no result without a card,
  and in a directory that holds nothing else of the repository; a phase
  whose child process (HyperMPMD's other role) exits non-zero fails, and
  a phase that fails kills its child.
"""
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from tests.conftest import REPO, run_subprocess  # noqa: E402


def test_port_imports_neither_jax_nor_the_reference():
    out = run_subprocess("""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert "repro_torch.serve.runtime" in names, names
assert "repro_torch.core.mpmd" in names, names
assert {"repro_torch.rl", "repro_torch.rl.buffer", "repro_torch.rl.learner",
        "repro_torch.rl.publish", "repro_torch.rl.rollout",
        "repro_torch.rl.session", "repro_torch.launch.rl"} <= set(names), names
print(len(names), "modules")
""", devices=1)
    assert "modules" in out


def test_serving_needs_a_card_unless_cpu_is_named(monkeypatch):
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    from repro_torch.serve.engine import Generator
    from repro_torch.serve.runtime import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b").reduced()
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    for ctor in (HyperServe, ServeEngine, Generator):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ctor(cfg, params)
    for mode in (["--continuous"], ["--batch", "2"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            launcher.main(["--arch", "qwen2-0.5b", "--reduced", *mode])
    serve = HyperServe(cfg, params, device="cpu")
    assert serve.engine.device.type == "cpu"


def test_launcher_serves_on_an_explicit_cpu(capsys):
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--continuous",
                   "--device", "cpu", "--requests", "3", "--max-new", "4",
                   "--block-size", "4", "--num-blocks", "64",
                   "--prefill-chunk", "8", "--metrics"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "on cpu" in out
    assert "serve_kernels_decode_fused" in out
    launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--continuous",
                   "--device", "cpu", "--requests", "2", "--max-new", "3",
                   "--kernels", "composed", "--metrics"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out
    assert "serve_kernels_decode_composed" in out
    assert "serve_kernels_decode_fused" not in out
    with pytest.raises(SystemExit, match="--disaggregate needs >= 2 "
                       "devices"):
        launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--continuous",
                       "--disaggregate", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-moe-16b",
                                  "moonshot-v1-16b-a3b"])
def test_launcher_serves_the_moe_archs_on_an_explicit_cpu(capsys, arch):
    """The MoE configs go through ``--arch`` like the dense ones: served
    continuously (the ragged MoE dispatch, MLA's latent pools for
    deepseek-v2-lite) and generated in a fixed batch."""
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", arch, "--reduced", "--continuous", "--device",
                   "cpu", "--requests", "2", "--max-new", "3",
                   "--block-size", "4", "--num-blocks", "64",
                   "--prefill-chunk", "8", "--metrics"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "on cpu" in out
    assert "serve_kernels_decode_fused" in out
    launcher.main(["--arch", arch, "--reduced", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "6", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out


def test_launcher_serves_mamba2_on_an_explicit_cpu(capsys):
    """mamba2-370m (SSD, per-seat state, no pages) through ``--arch``:
    served continuously, with no block ever taken, and generated in a
    fixed batch."""
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", "mamba2-370m", "--reduced", "--continuous",
                   "--device", "cpu", "--requests", "3", "--max-new", "4",
                   "--block-size", "4", "--num-blocks", "64",
                   "--prefill-chunk", "8", "--metrics"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "on cpu" in out
    assert "peak-free blocks=63 preemptions=0" in out
    launcher.main(["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "6", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out


def test_launcher_serves_recurrentgemma_on_an_explicit_cpu(capsys):
    """recurrentgemma-2b (RG-LRU seat state beside windowed LOCAL_ATTN
    pages) through ``--arch``: served continuously, fused and composed,
    and generated in a fixed batch."""
    from repro_torch.launch import serve as launcher
    for kernels in ("fused", "composed"):
        launcher.main(["--arch", "recurrentgemma-2b", "--reduced",
                       "--continuous", "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--block-size", "4", "--num-blocks",
                       "64", "--prefill-chunk", "8", "--kernels", kernels,
                       "--metrics"])
        out = capsys.readouterr().out
        assert "served 3 requests" in out and "on cpu" in out
        assert f"serve_kernels_decode_{kernels}" in out
    launcher.main(["--arch", "recurrentgemma-2b", "--reduced", "--device",
                   "cpu", "--batch", "2", "--prompt-len", "6", "--max-new",
                   "3"])
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out


@pytest.mark.parametrize("window", [0, 4])
def test_launcher_runs_fixed_batch_generation_on_an_explicit_cpu(capsys,
                                                                 window):
    """Without ``--continuous`` the launcher runs the dense ``Generator``
    over ``--batch`` prompts of ones, as the reference's does, windowed
    with ``--window``."""
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "8", "--max-new", "5",
                   "--window", str(window), "--metrics"])
    out = capsys.readouterr().out
    assert "generated 10 tokens" in out and "on cpu" in out
    first = out.split("first sequence:")[1].splitlines()[0]
    assert first.strip().startswith("[1, 1, 1, 1, 1, 1, 1, 1,")
    assert len(first.split(",")) == 13
    assert "jit_recompiles_dense_serve 1.0" in out


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card_or_the_repository(tmp_path):
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "No module named 'repro_torch'" in out.stderr


# chip_smoke.py's phases 42 and 44 with a child that joins the two-rank
# world and then dies (exit 3), or hangs: the phase fails on the child's
# exit code, and a phase that fails kills the child, each within seconds
MPMD_CHILD_CODE = """
import subprocess, sys, time
import chip_smoke as C
C.DEVICE = "cpu"
C.MPMD_TIMEOUT_S = 60
popen = subprocess.Popen
JOIN = ("import sys, time, torch.distributed as d; d.init_process_group("
        "'gloo', init_method=f'file://{sys.argv[1]}/store', "
        "rank=int(sys.argv[2]), world_size=2); ")
def child(then):
    def start(argv, *a, **k):
        return popen([sys.executable, "-c", JOIN + then, argv[4], argv[5]],
                     *a, **k)
    return start
C.subprocess.Popen = child("sys.exit(3)")
t0 = time.time()
try:
    with C.mpmd_pair("learner", 0) as report:
        report()
except AssertionError as e:
    print("DIED", e, round(time.time() - t0))
kids = []
def hang(argv, *a, **k):
    kids.append(child("time.sleep(600)")(argv, *a, **k))
    return kids[-1]
C.subprocess.Popen = hang
t0 = time.time()
try:
    with C.mpmd_pair("prefill", 1):
        raise ValueError("the phase failed")
except ValueError:
    print("KILLED", kids[0].poll() is not None, round(time.time() - t0))
"""


def test_chip_smoke_fails_a_phase_whose_child_fails():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", MPMD_CHILD_CODE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    lines = {ln.split()[0]: ln.split() for ln in out.stdout.splitlines()}
    assert "learner child exited with 3" in out.stdout, out.stderr[-2000:]
    assert int(lines["DIED"][-1]) < 30
    assert lines["KILLED"][1] == "True" and int(lines["KILLED"][2]) < 30


def test_kernel_ab_needs_two_checkouts_and_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    run = lambda *args: subprocess.run(  # noqa: E731
        [sys.executable, "kernel_ab.py", *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    out = run()
    assert out.returncode != 0 and "A_DIR B_DIR" in out.stderr
    out = run(REPO, REPO)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and out.stdout == ""


def test_train_depth_needs_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "train_depth.py", "qwen2-0.5b", "1", "2"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stderr.count("no CUDA device") == 2 and out.stdout == ""
