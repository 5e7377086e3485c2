"""The port's fp32 policy (core/device.py): where an entry point is handed
the card, fp32 convolutions and matmuls run in full fp32 (TF32 off for
cuDNN and cuBLAS), as the reference's ``Precision.HIGHEST``. The flags can
be set on a build without CUDA, so the CPU holds the rule; constructing
``torch.device("cuda")`` needs no card."""

import subprocess
import sys

import pytest
import torch

from metatransformer_tpu_torch.core import device as _device


@pytest.fixture
def tf32_on():
    """Both TF32 flags on for the test, restored after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("name", ["cuda", "cuda:0"])
def test_resolving_the_card_turns_tf32_off(tf32_on, name):
    assert _device.resolve(name) == torch.device(name)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_the_default_device_is_the_card_with_tf32_off(tf32_on, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _device.resolve(None).type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_resolving_the_cpu_leaves_the_flags_alone(tf32_on):
    assert _device.resolve("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_importing_the_package_leaves_the_flags_alone():
    """Every entry-point module imported in a fresh process with both flags
    on: they stay on until a device is resolved."""
    code = (
        "import torch\n"
        "torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True\n"
        "import metatransformer_tpu_torch\n"
        "from metatransformer_tpu_torch import demo, recipes, serving, train_cli  # noqa\n"
        "from metatransformer_tpu_torch.utils import registry  # noqa\n"
        "print(torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.split() == ["True", "True"]
