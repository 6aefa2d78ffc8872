"""The card marker and the scratch benchmark fixture of the benchmark's
CPU tests (`portbench_scratch`)."""
import pytest
from portbench_scratch import scratch_root, smoke_cells


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips on a host without one")


@pytest.fixture
def smoke_root(tmp_path):
    return scratch_root(tmp_path, smoke_cells())
