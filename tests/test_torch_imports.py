"""The port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of ``repro_torch`` and must end
with neither ``jax`` nor ``repro`` in ``sys.modules``; a scan of the
port's sources and ``chip_smoke.py`` finds no import of either.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_modules_import_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.serve.engine" in mods and len(mods) > 20
    # the PMT library, the Fig. 2 launcher and its kernel families
    assert {"repro_torch.core", "repro_torch.core.session",
            "repro_torch.core.sampler", "repro_torch.core.resolver",
            "repro_torch.core.monitor", "repro_torch.core.backends.nvml",
            "repro_torch.launch.fig2"} <= set(mods)
    for family in ("fma32", "stream", "gemm", "jacobi2d"):
        assert {f"repro_torch.kernels.{family}.{part}"
                for part in ("kernel", "ref", "ops")} <= set(mods)
    code = (
        "import sys\n"
        f"for m in {mods!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported: {out.stdout.strip()}"


_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_has_no_jax_or_repro_import(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.findall(text), f"{path} imports JAX or repro"
