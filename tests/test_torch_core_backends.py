"""The port's fault injection, host back ends and energy model against
the JAX package's.

Each test drives one script through ``repro.core`` and through
``repro_torch.core`` on a virtual clock and requires identical readings:

- scripted ``Fault`` windows (by read index) through
  ``FaultInjectingSensor``, bare and under ``SensorSupervisor`` with a
  fallback;
- the RAPL fixture trees of ``tests/test_pmt_core.py``, wraparound
  included, and its sysfs hwmon fixtures;
- the port's ``EnergyModel`` and ``H100CostModelSensor`` built on a
  ``HardwareSpec`` that carries the JAX ``TPU_V5E`` values, against the
  JAX ``EnergyModel`` and ``TpuCostModelSensor``.

The port ships ``H100_SXM`` in place of ``TPU_V5E``; its values are
checked against the H100 data sheet.
"""
import dataclasses
import os

import pytest

pytest.importorskip("torch")

import repro.core as jax_pmt  # noqa: E402
import repro_torch.core as torch_pmt  # noqa: E402
from repro.core.backends.tpu import TpuCostModelSensor  # noqa: E402
from repro_torch.core.backends.h100 import H100CostModelSensor  # noqa: E402

LIBS = (jax_pmt, torch_pmt)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _state(s):
    return (s.timestamp_s, s.joules, s.watts, dict(s.rails))


# -- faults ----------------------------------------------------------------

# One window of every kind, by read index, over a 40-read run.
PLAN = [("error", dict(start=2, count=2)),
        ("nan", dict(start=5, count=1)),
        ("spike", dict(start=7, count=1, factor=50.0)),
        ("reset", dict(start=9, count=3, reset_to=1.0)),
        ("stuck", dict(start=13, count=2)),
        ("flap", dict(start=16, count=6, period=3, duty=1)),
        ("hang", dict(start=23, count=1, hang_s=0.5)),
        ("negative", dict(start=25, count=1))]


def _meter(pmt, clk):
    """A sensor of ``pmt`` that reports a joules counter and watts, as a
    card's energy counter does: 40 + 5 t W, integrated exactly."""

    class Meter(pmt.Sensor):
        name = "meter"
        kind = "measured"
        native_period_s = 0.01

        def _sample(self):
            t = clk()
            return pmt.Sample(joules=40.0 * t + 2.5 * t * t,
                              watts=40.0 + 5.0 * t)

    return Meter(clock=clk)


def _faulted(pmt, plan, supervised, reads=40):
    clk = FakeClock()
    sleeps = []

    def sleep(s):
        sleeps.append(s)
        clk.advance(s)

    inner = _meter(pmt, clk)
    faulty = pmt.FaultInjectingSensor(
        inner, [pmt.Fault(kind, **kw) for kind, kw in plan], clock=clk,
        sleep_fn=sleep)
    sensor = faulty
    if supervised:
        fallback = pmt.create("dummy", watts=30.0, clock=clk)
        sensor = pmt.SensorSupervisor(
            [faulty, fallback], clock=clk, sleep_fn=sleep, retries=1,
            deadline_s=0.2, breaker_threshold=3, breaker_cooldown_s=1.0)
    readings = []
    for _ in range(reads):
        clk.advance(0.1)
        try:
            st = sensor.read()
        except pmt.SensorError as exc:
            readings.append(("error", str(exc)))
            continue
        readings.append(_state(st) + ((sensor.state,) if supervised
                                      else ()))
    out = dict(readings=repr(readings), injected=faulty.injected,
               sleeps=sleeps)
    if supervised:
        out["health"] = sensor.health()
    return out


@pytest.mark.parametrize("supervised", [False, True])
def test_fault_plan_gives_the_same_readings(supervised):
    ref, port = (_faulted(pmt, PLAN, supervised) for pmt in LIBS)
    assert port == ref
    assert all(n > 0 for n in port["injected"].values())
    if supervised:
        counters = port["health"]["counters"]
        assert counters["failovers"] > 0 and counters["counter_resets"] > 0


@pytest.mark.parametrize("kind,kw", PLAN, ids=[k for k, _ in PLAN])
def test_each_fault_kind_alone_gives_the_same_readings(kind, kw):
    for supervised in (False, True):
        ref, port = (_faulted(pmt, [(kind, kw)], supervised, reads=30)
                     for pmt in LIBS)
        assert port == ref
        assert port["injected"][kind] > 0


def test_fault_kinds_and_selectors_match():
    assert torch_pmt.FAULT_KINDS == jax_pmt.FAULT_KINDS
    for pmt in LIBS:
        with pytest.raises(ValueError):
            pmt.Fault("melt", start=0)
        with pytest.raises(ValueError):
            pmt.Fault("error")                       # no selector
        with pytest.raises(ValueError):
            pmt.Fault("flap", start=0, period=2, duty=3)


# -- RAPL (fixtures of tests/test_pmt_core.py) -------------------------------

def _write(path, content):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(str(content))


def make_rapl_tree(root, packages=2, energy_uj=1000000, max_range=10000000):
    for i in range(packages):
        zone = os.path.join(root, f"intel-rapl:{i}")
        _write(os.path.join(zone, "name"), f"package-{i}")
        _write(os.path.join(zone, "energy_uj"), energy_uj)
        _write(os.path.join(zone, "max_energy_range_uj"), max_range)
        sub = os.path.join(root, f"intel-rapl:{i}:0")
        _write(os.path.join(sub, "name"), "core")
        _write(os.path.join(sub, "energy_uj"), energy_uj // 2)
        _write(os.path.join(sub, "max_energy_range_uj"), max_range)


def _rapl_script(pmt, root, steps):
    """Read, then for each step write the zones' counters and read."""
    clk = FakeClock()
    s = pmt.create("rapl", root=root, clock=clk)
    assert s.kind == "measured"
    states = [_state(s.read())]
    for pkg_uj, core_uj in steps:
        for entry in sorted(os.listdir(root)):
            _write(os.path.join(root, entry, "energy_uj"),
                   core_uj if entry.count(":") == 2 else pkg_uj)
        clk.advance(1.0)
        states.append(_state(s.read()))
    return states


@pytest.mark.parametrize("packages,start,max_range,steps", [
    # two packages advance 0.5 J each, their core subzones 0.25 J
    (2, 1_000_000, 10_000_000, [(1_500_000, 750_000)]),
    # the package and core counters wrap over max_range
    (1, 9_900_000, 10_000_000, [(100_000, 100_000)]),
    # several reads, one wrap in the middle
    (2, 9_000_000, 10_000_000, [(9_500_000, 4_600_000),
                                (200_000, 4_700_000),
                                (1_200_000, 5_000_000)]),
], ids=["fixture-tree", "wraparound", "wrap-mid-run"])
def test_rapl_fixture_trees_read_the_same(tmp_path, packages, start,
                                          max_range, steps):
    states = []
    for pmt in LIBS:
        root = str(tmp_path / pmt.__name__ / "powercap")
        make_rapl_tree(root, packages, start, max_range)
        states.append(_rapl_script(pmt, root, steps))
    assert states[1] == states[0]
    joules = [st[1] for st in states[1]]
    assert all(b > a for a, b in zip(joules, joules[1:]))


def test_rapl_fixture_values_and_missing_tree(tmp_path):
    root = str(tmp_path / "powercap")
    make_rapl_tree(root, packages=1, energy_uj=9_900_000,
                   max_range=10_000_000)
    (_, j0, _, _), (_, j1, _, rails) = _rapl_script(
        torch_pmt, root, [(100_000, 100_000)])
    assert j1 - j0 == pytest.approx(0.2)                 # wrapped
    assert "intel-rapl:0:0:core" in rails
    for pmt in LIBS:
        with pytest.raises(pmt.SensorError):
            pmt.create("rapl", root=str(tmp_path / "nope"))


# -- sysfs (fixtures of tests/test_pmt_core.py) ------------------------------

def _sysfs_script(pmt, files, steps, root=""):
    """Read, then for each step write the files and read; rails are
    named relative to ``root``."""
    clk = FakeClock()
    s = pmt.create("sysfs", files=files, clock=clk)
    assert s.kind == "measured"

    def state():
        t, j, w, rails = _state(s.read())
        return t, j, w, {os.path.relpath(k, root): v
                         for k, v in rails.items()}

    states = [state()]
    for values in steps:
        for f, v in zip(files, values):
            _write(f, v)
        clk.advance(2.0)
        states.append(state())
    return states


@pytest.mark.parametrize("names,start,steps", [
    (["hwmon0/power1_input", "hwmon1/power1_input"],
     [25_000_000, 10_000_000], [[25_000_000, 10_000_000],
                                [30_000_000, 5_000_000]]),
    (["hwmon0/energy1_input"], [1_000_000], [[4_000_000], [9_000_000]]),
    (["hwmon0/power1_input", "hwmon0/energy1_input"],
     [20_000_000, 1_000_000], [[20_000_000, 3_000_000]]),
], ids=["power-files", "energy-files", "mixed"])
def test_sysfs_fixtures_read_the_same(tmp_path, names, start, steps):
    states = []
    for pmt in LIBS:
        root = tmp_path / pmt.__name__
        files = [str(root / n) for n in names]
        for f, v in zip(files, start):
            _write(f, v)
        states.append(_sysfs_script(pmt, files, steps, str(root)))
    assert states[1] == states[0]


def test_sysfs_power_values_and_rejected_file(tmp_path):
    p1 = str(tmp_path / "hwmon0" / "power1_input")
    p2 = str(tmp_path / "hwmon1" / "power1_input")
    _write(p1, 25_000_000)
    _write(p2, 10_000_000)
    (_, j0, _, _), (_, j1, w1, _) = _sysfs_script(
        torch_pmt, [p1, p2], [[25_000_000, 10_000_000]])
    assert j1 - j0 == pytest.approx(70.0) and w1 == pytest.approx(35.0)
    bad = str(tmp_path / "hwmon0" / "temp1_input")
    _write(bad, 42)
    for pmt in LIBS:
        with pytest.raises(pmt.SensorError):
            pmt.create("sysfs", files=[bad])


# -- energy model and the modeled card sensor ---------------------------------

def _tpu_values_spec():
    """The port's HardwareSpec carrying the JAX TPU_V5E values."""
    return torch_pmt.HardwareSpec(**dataclasses.asdict(jax_pmt.TPU_V5E))


@pytest.mark.parametrize("flops,hbm,ici,seconds,chips", [
    (0.0, 0.0, 0.0, 0.3, 1),
    (1e12, 2e9, 0.0, 0.01, 1),
    (5e14, 1e10, 1e9, 0.001, 4),        # capped at the board envelope
    (1e9, 1e6, 0.0, 0.0, 2),            # zero duration
])
def test_energy_model_matches_jax_on_the_same_spec(flops, hbm, ici,
                                                   seconds, chips):
    ref = jax_pmt.EnergyModel(hw=jax_pmt.TPU_V5E)
    port = torch_pmt.EnergyModel(hw=_tpu_values_spec())
    assert port.dynamic_joules(flops, hbm, ici) == ref.dynamic_joules(
        flops, hbm, ici)
    assert port.static_joules(seconds, chips) == ref.static_joules(
        seconds, chips)
    assert port.step_joules(flops, hbm, ici, seconds, chips) \
        == ref.step_joules(flops, hbm, ici, seconds, chips)
    assert port.step_watts(flops, hbm, ici, seconds, chips) \
        == ref.step_watts(flops, hbm, ici, seconds, chips)


def _cost_script(sensor, clk):
    out = [_state(sensor.read())]
    for flops, hbm, ici, dt in ((1e12, 1e9, 0.0, 0.01), (0.0, 0.0, 0.0, 0.5),
                                (4e14, 8e9, 2e8, 0.002),
                                (2e13, 3e10, 0.0, 0.25)):
        clk.advance(dt)
        out.append(sensor.account(flops, hbm, ici, dt))
        out.append(_state(sensor.read()))
        clk.advance(0.5)                  # idle: the burst ends
        out.append(_state(sensor.read()))
    return out


def test_h100_sensor_matches_the_tpu_sensor_on_the_same_spec():
    readings = []
    for make in (lambda clk: TpuCostModelSensor(
                     model=jax_pmt.EnergyModel(), chips=2, clock=clk),
                 lambda clk: H100CostModelSensor(
                     model=torch_pmt.EnergyModel(hw=_tpu_values_spec()),
                     chips=2, clock=clk)):
        clk = FakeClock(10.0)
        readings.append(_cost_script(make(clk), clk))
    assert readings[1] == readings[0]


def test_h100_spec_and_sensor_defaults():
    hw = torch_pmt.H100_SXM
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes, hw.peak_w) == (
        989e12, 3.35e12, 80e9, 700.0)
    assert 121.9 <= hw.idle_w <= 128.9         # the card's SLEEP rows
    assert torch_pmt.EnergyModel().hw is hw
    model = torch_pmt.EnergyModel()
    ref = jax_pmt.EnergyModel()
    assert (model.pj_per_flop, model.pj_per_hbm_byte,
            model.pj_per_ici_byte) == (ref.pj_per_flop, ref.pj_per_hbm_byte,
                                       ref.pj_per_ici_byte)
    clk = FakeClock()
    s = torch_pmt.create("h100", clock=clk)
    assert isinstance(s, H100CostModelSensor)
    assert s.kind == "modeled" and s.model.hw is hw
    a = s.read()
    clk.advance(2.0)
    b = s.read()
    assert torch_pmt.watts(a, b) == pytest.approx(hw.idle_w)


def test_registry_names_every_backend():
    assert torch_pmt.backend_names() == ["cpuutil", "dummy", "h100", "nvml",
                                         "rapl", "sysfs"]
    kinds = {n: torch_pmt.get_backend(n).kind
             for n in torch_pmt.backend_names()}
    assert kinds == {"cpuutil": "hybrid", "dummy": "modeled",
                     "h100": "modeled", "nvml": "measured",
                     "rapl": "measured", "sysfs": "measured"}
    jax_names = set(jax_pmt.backend_names())
    assert set(torch_pmt.backend_names()) == jax_names - {"tpu"} | {"h100"}
