"""pytest settings of the benchmark's own tests (``perfbench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped where there is none")
