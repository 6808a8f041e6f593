"""Pytest settings shared by the test files: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one); run on "
                   "the card with `pytest -m cuda tests/test_torch_*.py`")
