"""PyTorch / CUDA port of clg_vqa_tpu for NVIDIA Hopper (H100).

Each module sits at the same relative path as its JAX counterpart in
``clg_vqa_tpu`` and is held against it by the ``tests/test_torch_*.py``
parity tests. The port imports neither JAX nor any module of the JAX
package; what it needs of the JAX package's framework-free modules it keeps
as its own copies.

Entry points (``models.uc2.UC2``, ``data.device_bank.DeviceFeatureBank``,
``eval.runner.run_eval``, ``eval.predictor.Predictor``,
``train.driver.FinetuneRunner``, ``python -m clg_vqa_tpu_torch.cli``) run on
``cuda`` unless the caller passes ``device="cpu"`` (the CLI:
``--device cpu``); see :func:`resolve_device`.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises when CUDA is absent and the caller did not ask for the CPU, so
    that a missing card never turns into a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
