"""Device selection of the port.

The port runs on the CUDA card unless the caller asks for the CPU. Setting
up a CUDA device also turns TF32 off for matmuls and cuDNN: a reduced-
precision blur inflates fine-scale DoG extrema (2.5x, measured on the JAX
package's single-pass bf16 matmul).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for (or implied)
    and no card is available; never falls back to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "siftmetal_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
