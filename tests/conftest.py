"""Shared pytest settings: registers the marker of tests that need a
CUDA card (they skip, from a fixture, where there is none)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")
