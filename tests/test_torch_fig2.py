"""The port's Fig. 2 launcher (``repro_torch.launch.fig2``) on the CPU.

``--device cpu --smoke`` runs the plain versions at small shapes under a
``cpuutil``-only session; the table must list the JAX bench's rows
(``benchmarks/bench_fig2_kernels.py``) in its order, with GRIDDER and
DEGRIDDER marked as not ported.  The card's columns are checked on
rows built by hand: a CPU run has no card numbers.
"""
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import fig2  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _jax_bench_rows():
    src = (ROOT / "benchmarks" / "bench_fig2_kernels.py").read_text()
    return re.findall(r'(?:_run\(|rows\.append\(\()"([A-Z0-9]+)"', src)


def test_cpu_smoke_prints_the_jax_bench_rows_in_order(capsys):
    rows = fig2.main(["--device", "cpu", "--smoke"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# Fig. 2 on cpu")
    table = out[2:]
    assert [line.split()[0] for line in table] == _jax_bench_rows()
    assert list(fig2.ROW_NAMES) == _jax_bench_rows()
    for line in table:
        if line.split()[0] in ("GRIDDER", "DEGRIDDER"):
            assert line.endswith("not ported yet (next slice)")
    assert [r.name for r in rows] == ["SLEEP", "FMA32", "STREAM", "GEMM",
                                      "JACOBI2D"]
    for r in rows:
        assert r.calls >= 1 and math.isfinite(r.host_watts)
        assert r.seconds >= fig2.SMOKE["min_seconds"] * 0.9
        assert r.card_watts is None and r.card_joules is None


def test_launcher_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fig2.run()


def test_card_columns_from_rows():
    # an FMA32 row at the full size, 10 calls at 4.1 ms (twice its
    # 2.05 ms bound), 300 W on the card
    (shape, iters) = fig2.FULL["fma32"]
    n = shape[0] * shape[1]
    row = fig2.Row(name="FMA32", calls=10, seconds=0.041, host_watts=20.0,
                   card_watts=300.0, card_joules=12.3,
                   flops=2.0 * n * iters, nbytes=8.0 * n)
    assert row.bound_by == "operations"
    assert row.bound_s == pytest.approx(2.0 * n * iters / 67e12)
    sleep = fig2.Row(name="SLEEP", calls=1, seconds=2.0, host_watts=10.0,
                     card_watts=70.0, card_joules=140.0)
    stream = fig2.Row(name="STREAM", calls=4, seconds=0.008,
                      host_watts=20.0, card_watts=400.0, card_joules=3.2,
                      flops=2.0, nbytes=12.0)
    jac = fig2.Row(name="JACOBI2D", calls=1, seconds=1.0, host_watts=1.0,
                   card_watts=1.0, card_joules=1.0, flops=5.0, nbytes=8.0)
    gemm = fig2.Row(name="GEMM", calls=1, seconds=1.0, host_watts=1.0,
                    card_watts=1.0, card_joules=1.0, flops=2e12,
                    nbytes=1e9)
    lines = {line.split()[0]: line
             for line in fig2.format_rows([sleep, row, stream, gemm, jac])}
    fma = lines["FMA32"].split()
    tflops = 2.0 * n * iters / 0.0041 / 1e12
    assert fma[5:7] == [f"{tflops:.2f}", "TFLOP/s"]
    assert fma[7] == f"{100 * row.bound_s / 0.0041:.1f}%"
    gflops_per_w = 2.0 * n * iters * 10 / 12.3 / 1e9
    assert fma[8] == f"{gflops_per_w:.2f}"
    assert lines["STREAM"].split()[6] == "TB/s"
    assert lines["SLEEP"].split()[5:] == ["-", "-", "-"]
