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


# -- NvmlSensor: the card as a PMT sensor ---------------------------------

class FakeReader:
    """Stands in for ``NvmlReader``: a counter that gains ``watts`` joules
    per second of a virtual clock, or none when ``counter`` is False."""

    def __init__(self, clock, watts=250.0, counter=True):
        self.clock, self.watts, self.counter = clock, watts, counter
        self.base = 1.0e6                    # joules counted before the test

    def energy_joules(self):
        if not self.counter:
            return None
        return self.base + self.watts * self.clock()

    def power_watts(self):
        return self.watts


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("counter", [True, False])
def test_nvml_sensor_reads_counter_or_integrates_power(counter):
    clk = Clock()
    sensor = nvml.NvmlSensor(clock=clk, reader=FakeReader(clk,
                                                          counter=counter))
    assert sensor.method == ("energy-counter" if counter
                             else "power-integral")
    a = sensor.read()
    clk.t = 2.0
    b = sensor.read()
    assert sensor.joules(a, b) == pytest.approx(500.0)
    assert sensor.watts(a, b) == pytest.approx(250.0)
    assert b.watts == 250.0
    if counter:
        assert b.joules == pytest.approx(1.0e6 + 500.0)   # the counter itself


@pytest.mark.parametrize("counter", [True, False])
def test_nvml_sensor_in_a_session_region(counter):
    import repro_torch.core as pmt
    clk = Clock()
    sensor = nvml.NvmlSensor(clock=clk, reader=FakeReader(clk, watts=300.0,
                                                          counter=counter))
    with pmt.Session([sensor], pool=pmt.SensorPool(), period_s=1e6) as s:
        with s.region("work") as r:
            clk.t += 1.5
        m = r.measurements.by_sensor("nvml")
    assert m.kind == "measured"
    assert m.joules == pytest.approx(450.0)
    assert m.seconds == pytest.approx(1.5)


def test_nvml_backend_is_registered_and_unavailable_without_a_card():
    import repro_torch.core as pmt
    cls = pmt.get_backend("nvml")
    assert cls is nvml.NvmlSensor
    assert (cls.name, cls.kind, cls.native_period_s) == ("nvml", "measured",
                                                         0.010)
    try:
        nvml.NvmlReader().close()
        have_card = True
    except nvml.NvmlError:
        have_card = False
    assert cls.is_available() == have_card
    if not have_card:
        with pytest.raises(pmt.SensorError, match="NVML backend unavailable"):
            pmt.create("nvml")
