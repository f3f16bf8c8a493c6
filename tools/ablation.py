"""The harness the ablation scripts share (tools/ablate_attention.py,
tools/ablate_decode.py).

No kernel profiler runs where the card is, so a script builds variants of
one CUDA source with parts of the work cut out (plain string edits, each
checked to apply), times each variant's launches with torch.profiler, and
prints the cost of each part as the difference of consecutive variants in
a chain of cuts.  Needs a CUDA device and nvcc; variants are built under
build/ablation/<source>/.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")


def card(tool: str) -> str:
    """The card's name and power limit, as nvidia-smi gives them; exits 2
    where there is no CUDA device."""
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device is available", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    return smi


def chain_variants(cut: dict, chain, other: dict = None) -> dict:
    """{variant: edits}: the full kernel; then, for each part of `chain`,
    the kernel without that part and those before it; then the kernel
    without `cut["every stage"]`; then the `other` variants."""
    out = {"full": []}
    edits = []
    for part in chain:
        edits = edits + cut[part]
        out[f"without {part}"] = edits
    out["without every stage"] = cut["every stage"]
    out.update(other or {})
    return out


def build(source: str, variants: dict, signatures: dict, expand=lambda s: s) -> dict:
    """{variant: (loaded library, edited source)}: `source`.cu of csrc/
    with each variant's (old, new) edits, `expand` applied to each new
    text; one nvcc per variant, all at once."""
    src = open(os.path.join(CSRC, f"{source}.cu")).read()
    nvcc, procs = _build._nvcc(), {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"ablation: the edit {old[:48]!r} no longer "
                                 f"applies to {source}.cu")
            text = text.replace(old, expand(new))
        d = os.path.join(ROOT, "build", "ablation", source, str(i))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{source}.cu"), "w") as f:
            f.write(text)
        for h in os.listdir(CSRC):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(CSRC, h), d)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
               os.path.join(d, f"{source}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), d, text)
    libs = {}
    for name, (proc, d, text) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ablation: nvcc failed for {name}:\n{log}")
        regs = [ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"  built {name}: registers {regs}", flush=True)
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, text)
    return libs


def time_calls(calls: dict, kernel: str, n: int = 20) -> dict:
    """{shape: device us per launch of `kernel`} over n calls of each."""
    t = {}
    for k, f in calls.items():
        for _ in range(5):   # the profiler may drop a session's events
            us, seen = cs.kernel_us(cs.profiled(f, n), kernel)
            if seen == n:
                break
        if seen != n:
            raise SystemExit(f"ablation: the profiler saw {seen} of {n} launches")
        t[k] = us / n
    return t


def print_times(label: str, times: dict) -> None:
    print(f"{label:34s}" + "".join(f"  {k}: {t:8.2f} us" for k, t in times.items()),
          flush=True)


def print_chain(times: dict, chain, calls, rest: str) -> None:
    """Each part's cost: the variant before it less the variant without it;
    then the rest of the stage loop, and `rest`: the kernel with no stage."""
    print("cost of each part, us per launch (the variant before it less the "
          "variant without it):")
    prev = "full"
    for part in chain:
        name = f"without {part}"
        print(f"  {part:32s}" + "".join(
            f"  {k}: {times[prev][k] - times[name][k]:8.2f}" for k in calls), flush=True)
        prev = name
    print(f"  {'the rest of the stage loop':32s}" + "".join(
        f"  {k}: {times[prev][k] - times['without every stage'][k]:8.2f}" for k in calls))
    print(f"  {rest:32s}" + "".join(
        f"  {k}: {times['without every stage'][k]:8.2f}" for k in calls))


def write(path: str, smi: str, times: dict) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(card=smi, us_per_launch=times), f, indent=1)
