"""Time design variants of the DEGRIDDER and JACOBI2D kernels on one card.

    python3 kernel_variants.py

Each variant is a shipped source of ``src/repro_torch/kernels/csrc``
(``gridder.cu``, ``jacobi2d.cu``) with some of its ``constexpr int``
constants set to other values, so the sources carry no knobs.  Every
variant is built alone (``build.NVCC_FLAGS``, one ``nvcc`` each, all
started together) into the git-ignored ``build/variants/``, loaded with
``ctypes``, checked against the plain version once (the degridder within
rtol 1e-4, atol 2e-3; JACOBI2D exactly) and timed with ``chip_smoke``'s
``time_ms`` at the Fig. 2 sizes (the degridder at P 1024, S 1024, V 2048
with lm in [-0.5, 0.5] and uv in [-2, 2]; JACOBI2D at 16384^2 f32, beside
``x.clone()``, which moves the same bytes).  ROUNDS rounds, each variant
once a round, the order rotated round by round.  Prints the card's name
and power limit, each variant's registers and spills (ptxas), then one
JSON line a variant: median and quartiles of its ms.  Imports nothing of
JAX; needs one card.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 10
# name -> (source, entry point, {constant: value}); {} is the shipped design
VARIANTS = {
    "degridder": ("gridder.cu", "pmt_degridder", {}),
    "degridder 64 threads": ("gridder.cu", "pmt_degridder",
                             {"DTHREADS": 64}),
    "degridder 128 threads": ("gridder.cu", "pmt_degridder",
                              {"DTHREADS": 128}),
    "degridder 512 threads": ("gridder.cu", "pmt_degridder",
                              {"DTHREADS": 512}),
    "degridder VPT 4": ("gridder.cu", "pmt_degridder", {"VPT": 4}),
    "degridder 128 threads VPT 4": ("gridder.cu", "pmt_degridder",
                                    {"DTHREADS": 128, "VPT": 4}),
    "jacobi2d": ("jacobi2d.cu", "pmt_jacobi2d", {}),
    "jacobi2d ROWS 2": ("jacobi2d.cu", "pmt_jacobi2d", {"ROWS": 2}),
    "jacobi2d ROWS 8": ("jacobi2d.cu", "pmt_jacobi2d", {"ROWS": 8}),
    "jacobi2d ROWS 16": ("jacobi2d.cu", "pmt_jacobi2d", {"ROWS": 16}),
    "jacobi2d ROWS 32": ("jacobi2d.cu", "pmt_jacobi2d", {"ROWS": 32}),
    "jacobi2d 64 threads": ("jacobi2d.cu", "pmt_jacobi2d",
                            {"THREADS": 64}),
    "jacobi2d 256 threads": ("jacobi2d.cu", "pmt_jacobi2d",
                             {"THREADS": 256}),
}


def variant_source(text: str, values: dict) -> str:
    for name, value in values.items():
        text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise AssertionError(f"no single constant {name} to set")
    return text


def build_all(build) -> dict:
    """{variant: ctypes library}, each built from its own source."""
    procs = {}
    for i, (name, (source, entry, values)) in enumerate(VARIANTS.items()):
        out = ROOT / "build" / "variants" / str(i)
        out.mkdir(parents=True, exist_ok=True)
        src = out / source
        src.write_text(variant_source((build.CSRC / source).read_text(),
                                      values))
        procs[name] = (out / "lib.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-shared", str(src), "-o", str(out / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        ptxas = [line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line]
        print(f"{name}: ptxas " + " | ".join(ptxas), flush=True)
        lib = ctypes.CDLL(str(path))
        entry = VARIANTS[name][1]
        getattr(lib, entry).argtypes = build.SIGNATURES[entry]
        libs[name] = lib
    return libs


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.gridder import ref as grid_ref
    from repro_torch.kernels.jacobi2d import ref as jac_ref

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    libs = build_all(build)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    g = torch.Generator(device=dev).manual_seed(11)
    p, s, v = 1024, 1024, 2048
    lm = torch.rand((p, 2), generator=g, device=dev) - 0.5
    uv = 4.0 * torch.rand((s, v, 2), generator=g, device=dev) - 2.0
    sub = torch.randn((s, p, 2), generator=g, device=dev)
    vis = torch.empty((s, v, 2), device=dev)
    x = smoke._randn(dev, 16384, 16384, seed=10)
    y = torch.empty_like(x)
    calls = {"x.clone()": lambda: x.clone()}
    for name, lib in libs.items():
        if name.startswith("degridder"):
            calls[name] = lambda lib=lib: lib.pmt_degridder(
                lm.data_ptr(), uv.data_ptr(), sub.data_ptr(),
                vis.data_ptr(), s, p, v, stream())
        else:
            calls[name] = lambda lib=lib: lib.pmt_jacobi2d(
                x.data_ptr(), y.data_ptr(), 16384, 16384, stream())
    want_vis = grid_ref.degridder_ref(lm, uv, sub)
    want_y = jac_ref.jacobi2d_ref(x)
    for name in libs:
        if calls[name]():
            raise RuntimeError(f"{name}: the launch failed")
        torch.cuda.synchronize()
        if name.startswith("degridder"):
            excess = float(((vis - want_vis).abs()
                            - 1e-4 * want_vis.abs()).max())
            if not excess <= 2e-3:
                raise AssertionError(f"{name} disagrees: {excess}")
        elif not torch.equal(y, want_y):
            raise AssertionError(f"{name} disagrees with the plain version")
    del want_vis, want_y
    times = {name: [] for name in calls}
    names = list(calls)
    for r in range(ROUNDS):
        for name in names[r % len(names):] + names[:r % len(names)]:
            times[name].append(smoke.time_ms(calls[name]))
    for name, ts in times.items():
        print(json.dumps({"variant": name, "median_ms": statistics.median(
            ts), "quartiles_ms": statistics.quantiles(ts, n=4)[::2]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
