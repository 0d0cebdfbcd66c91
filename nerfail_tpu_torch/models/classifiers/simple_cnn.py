"""SimpleCNN, the CPU-test classifier, and MyCNN, the zoo's `my_model`.

Capability-parity with the reference MyCNN (model/MyModel.py:5-53): a
7-stage conv(3×3)+ReLU+maxpool(2) pyramid 32→64→128→256→256→128→64,
then a global average pool and two fully-connected layers, so any input
resolution works. Parameters start as flax's defaults would
(common.flax_default_init), so training from scratch follows the JAX
model's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfail_tpu_torch.models.classifiers.common import (
    flax_default_init, global_avg_pool, nhwc_to_nchw, scale_input,
)

FEATURES = (32, 64, 128, 256, 256, 128, 64)


class SimpleCNN(nn.Module):
    def __init__(self, num_classes: int = 8, in_ch: int = 3):
        super().__init__()
        for i, feats in enumerate(FEATURES):
            setattr(self, f"Conv_{i}", nn.Conv2d(in_ch, feats, 3, padding=1))
            in_ch = feats
        self.Dense_0 = nn.Linear(in_ch, 512)
        self.Dense_1 = nn.Linear(512, num_classes)
        flax_default_init(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(scale_input(x))
        for i in range(len(FEATURES)):
            x = torch.relu(getattr(self, f"Conv_{i}")(x))
            if min(x.shape[2], x.shape[3]) >= 2:  # guard small test inputs
                x = F.max_pool2d(x, 2, 2)
        x = global_avg_pool(x)
        x = torch.relu(self.Dense_0(x))
        return self.Dense_1(x)


class MyCNN(nn.Module):
    """The reference MyCNN (model/MyModel.py:5-53), the zoo's `my_model`.

    Unlike SimpleCNN above it keeps every reference quirk, as the JAX
    package's MyCNN does: VALID convolutions, floor-dividing 2×2 max
    pools, the raw 0-255 input with no scaling, and a flatten in (c, h, w)
    order whose 1024 features pin the input to 800². Parameters start as
    torch's defaults."""

    def __init__(self, num_classes: int = 8, in_ch: int = 3):
        super().__init__()
        for i, feats in enumerate(FEATURES):
            setattr(self, f"Conv_{i}", nn.Conv2d(in_ch, feats, 3))
            in_ch = feats
        self.Dense_0 = nn.Linear(in_ch * 4 * 4, 512)
        self.Dense_1 = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(x)
        for i in range(len(FEATURES)):
            x = F.max_pool2d(torch.relu(getattr(self, f"Conv_{i}")(x)), 2, 2)
        x = torch.relu(self.Dense_0(torch.flatten(x, 1)))
        return self.Dense_1(x)
