"""The port's NVML reader: the power integral it falls back on, and a
clear error where the NVML library is absent."""
import pytest

pytest.importorskip("torch")

from repro_torch.core.backends import nvml  # noqa: E402


def test_power_integrator_is_trapezoidal_on_a_fake_clock():
    t = [0.0]
    watts = iter([100.0, 100.0, 200.0, 200.0])

    def clock():
        return t[0]

    integ = nvml.PowerIntegrator(lambda: next(watts), clock=clock)
    integ._tick()                 # t=0, 100 W
    t[0] = 1.0
    integ._tick()                 # t=1, 100 W -> 100 J
    t[0] = 3.0
    integ._tick()                 # t=3, 200 W -> +300 J
    t[0] = 4.0
    integ._tick()                 # t=4, 200 W -> +200 J
    assert integ.joules == pytest.approx(600.0)
    assert integ.samples == 4


def test_power_integrator_thread_starts_and_stops():
    integ = nvml.PowerIntegrator(lambda: 50.0, period_s=0.001)
    integ.start()
    joules = integ.stop()
    assert integ.samples >= 2 and joules >= 0.0
    assert not integ._thread.is_alive()


def test_energy_meter_integrates_where_counter_is_unsupported():
    class Reader:
        def energy_joules(self):
            return None

        def power_watts(self):
            return 10.0

    meter = nvml.EnergyMeter(Reader())
    meter.start()
    assert meter.method == "power-integral-10ms"
    assert meter.stop() >= 0.0


def test_energy_meter_differences_the_counter():
    class Reader:
        def __init__(self):
            self.e = iter([1000.0, 1012.5])

        def energy_joules(self):
            return next(self.e)

    meter = nvml.EnergyMeter(Reader())
    meter.start()
    assert meter.method == "energy-counter"
    assert meter.stop() == pytest.approx(12.5)


def test_missing_library_raises_nvml_error():
    with pytest.raises(nvml.NvmlError, match="cannot load"):
        nvml.NvmlReader(library="libnvidia-ml-absent.so.1")
