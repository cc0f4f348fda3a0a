"""Time the CUDA kernels of two checkouts in turns on one card.

Run from the root of a checkout, with another checkout of the repository
(for example the parent commit unpacked with ``git archive``) as argument::

    python3 compare_kernels.py OTHER_ROOT [NAME ...]

It runs ``python3 compare_kernels.py --measure ROOT`` for OTHER_ROOT, this
checkout, this checkout and OTHER_ROOT, in that order; each process imports
``audioforge_tpu_torch`` from its ROOT and builds that checkout's kernels.
The configurations and their inputs are chip_smoke.py phase [2]'s
(``timed_calls``: the serving shapes at fleet 1024, made from fixed seeds,
the same in every process), all of them or those whose label starts with
one of the NAMEs. A time is the card's time per call (chip_smoke.py
``kernel_times``: a CUDA graph of the calls replayed, without the host's
launch cost). It prints the card's name and power limit, each run's times
and, per configuration, both runs of each checkout.

``python3 compare_kernels.py OTHER_ROOT --replays`` runs six processes in
turns (OTHER_ROOT, this, OTHER_ROOT, this, this, OTHER_ROOT), each timing two
replays on its checkout's package: chip_smoke.py's VAD-on serving path at fleet 1024
([8], ``phase_model_path`` with REPLAY_TIMED_CALLS timed calls; its graph's
replay alone) and the live engine's VAD worker (``vad_window_times``: its
window graph's replay alone, host ms a window). A replay's time can differ
between processes of one tree, hence six processes.

``python3 compare_kernels.py OTHER_ROOT --host`` runs four processes in
turns (OTHER_ROOT, this, this, OTHER_ROOT), each running its own
checkout's chip_smoke.py phases [3] (default path), [4] (full chain) and
[8] (VAD-on) at fleet 1024 on its own package, and prints what they print
of the serving host path: step(), step_many and step_pipelined() p50 and
p99, the mean host time of step() with its split by stage, and the
replay alone (ms a block).
Each checkout times with its own helpers, so the two engines' internals
may differ.

``python3 compare_kernels.py --sass FUNCTION ...`` builds this checkout's
kernels and prints the SASS (``cuobjdump -sass``) of every kernel function
whose name contains one of the FUNCTIONs, for reading a loop's dependency
chain or checking that a kernel's loads go out together.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPLAY_TIMED_CALLS = 50


def measure(root: str, names: list[str]) -> dict:
    """Times in ms of the kernels of the checkout at ``root``."""
    import torch

    import chip_smoke as cs  # this checkout's helpers; the package from root

    sys.path.insert(0, str(Path(root).resolve()))
    cs.check(torch.cuda.is_available(), "no CUDA device")
    out = {}
    for label, call, reps, blocks in cs.timed_calls():
        if not names or any(label.startswith(n) for n in names):
            out[label] = cs.kernel_times(call, reps)[0] / blocks
    return out


def measure_replays(root: str) -> dict:
    """The replays' times in ms on the package of the checkout at ``root``."""
    import chip_smoke as cs  # this checkout's helpers; the package from root

    sys.path.insert(0, str(Path(root).resolve()))
    card = cs.phase0_device()
    cs.phase1_build()
    cs.MODEL_TIMED_CALLS = REPLAY_TIMED_CALLS
    cs.phase_model_path(card, "VAD-on", "[8]")
    window_ms, call_ms = cs.vad_window_times()
    return {"VAD-on replay": cs.REPLAY_MS["[8]"], "VAD window replay": window_ms,
            "VAD window host": call_ms}


HOST_PHASES = ('c.phase3_default(card); c.phase4_full_chain(card); '
               'c.phase_model_path(card, "VAD-on", "[8]")')
HOST_LINE = re.compile(
    r"^(\[\d+\]) (step\(\)|step_many\(\d+\) per block|step_pipelined\(\)) x \d+ blocks "
    r"\(info, [^)]*\): p50 ([\d.]+) ms, p99 ([\d.]+) ms")
HOST_TOTAL = re.compile(r"^(\[\d+\]) step\(\) host split, mean ms .*?: total ([\d.]+): (.*)$")
HOST_REPLAY = re.compile(r"^(\[\d+\]) replay alone on the card \(info, [^)]*\): ([\d.]+) ms")


def measure_host(root: str) -> dict:
    """The serving host path's times in ms a block, from the chip_smoke.py
    of the checkout at ``root`` run on its own package."""
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as c; card = c.phase0_device(); "
         f"c.phase1_build(); {HOST_PHASES}"],
        capture_output=True, text=True, check=False, cwd=root)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: chip_smoke phases failed\n{proc.stdout[-4000:]}"
                           f"{proc.stderr[-4000:]}")
    out = {}
    for line in proc.stdout.splitlines():
        if m := HOST_LINE.match(line):
            out[f"{m[1]} {m[2]} p50"], out[f"{m[1]} {m[2]} p99"] = float(m[3]), float(m[4])
        elif m := HOST_TOTAL.match(line):
            out[f"{m[1]} step() host mean"] = float(m[2])
            for part in m[3].split(", "):  # the split's stages, each checkout's own
                label, ms = part.rsplit(" ", 1)
                out[f"{m[1]} host {label}"] = float(ms)
        elif m := HOST_REPLAY.match(line):
            out[f"{m[1]} replay alone"] = float(m[2])
    return out


def sass(names: list[str]) -> str:
    """The SASS of this checkout's kernel functions whose names contain one
    of ``names``."""
    from audioforge_tpu_torch import kernels

    lib = kernels.build()
    tool = Path(kernels._find_nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : ", dump)
    return "".join(f"Function : {p}" for p in parts[1:]
                   if any(n in p.splitlines()[0] for n in names))


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--sass":
        print(sass(sys.argv[2:]))
        return 0
    if len(sys.argv) >= 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2], sys.argv[3:])))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--measure-replays":
        print(json.dumps(measure_replays(sys.argv[2])))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--measure-host":
        print(json.dumps(measure_host(sys.argv[2])))
        return 0
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    other, names = str(Path(sys.argv[1]).resolve()), sys.argv[2:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60)
    print(smi.stdout.strip() or "card not measured", flush=True)
    this = str(HERE)
    if names == ["--replays"]:
        mode, names, turns = "--measure-replays", [], (other, this, other, this, this, other)
    elif names == ["--host"]:
        mode, names, turns = "--measure-host", [], (other, this, this, other)
    else:
        mode, turns = "--measure", (other, this, this, other)
    runs = []
    for root in turns:
        label = "this" if root == this else "other"
        proc = subprocess.run([sys.executable, str(HERE / "compare_kernels.py"), mode, root,
                               *names], capture_output=True, text=True, check=False, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((label, times))
        print(f"{label} ({root}): {json.dumps(times)}", flush=True)
    # a configuration or stage one checkout lacks shows as [] on its side
    for name in dict.fromkeys(name for _, times in runs for name in times):
        med = {lab: sorted(t[name] for lb, t in runs if lb == lab and name in t)
               for lab in ("other", "this")}
        print(f"{name}: other {med['other']} ms, this {med['this']} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
