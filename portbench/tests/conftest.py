"""CPU tests of the port's benchmark: run from the repository root with
``python -m pytest portbench/tests``. The tests marked ``cuda`` need the
card and skip elsewhere (decided in the `card` fixture)."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import portbench_testlib  # noqa: E402,F401  (puts the benchmark and src on the path)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
