import pytest
import torch

# the tests run tiny cells in parallel workers: one intra-op thread each
# keeps the workers from oversubscribing the host's cores
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skipped where "
        "torch.cuda.is_available() is False")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the benchmark's runs measure the "
                    "card")
    return torch.device("cuda")
