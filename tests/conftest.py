"""Registers the `gpu` marker: tests that need a CUDA card skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips on machines without one)"
    )
