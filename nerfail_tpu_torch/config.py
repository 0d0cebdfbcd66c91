"""Attack configuration and the reference's scene tables.

The PyTorch port keeps only what the NeRFail-S slice reads: the shared
attack knobs and the mask-view / scene-class tables. Field names, defaults
and table contents are those of `nerfail_tpu.config`, so a configuration
means the same thing to both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class AttackConfig:
    """Shared attack-engine knobs (attack_NeRFail.py:28-48 & friends)."""

    method: str = "NeRFail"       # NeRFail | NeRFail_S | UAP_2D | IGSM_2D
    eps: float = 32.0             # L∞ budget in 0-255 space
    a: float = 2.0                # sign-step size (NeRFail_S / IGSM)
    m1: float = 8.0               # deepfool margin on current class
    m2: float = 100.0             # deepfool margin on candidate classes
    attack_epochs: int = 100
    df_max_iter: int = 1000
    overshoot: float = 0.02
    beta: float = 0.0             # MSE regulariser weight in NeRFail_S loss
    batch_size: int = 8
    targeted: bool = False
    target_label: int = 0
    base_mask_number: int = 3     # p: number of base mask views
    # NeRFail (DeepFool) only: views that run DeepFool together per
    # accumulation step; 1 is the reference's sequential semantics.
    view_batch: int = 1


# Mask-view index tables, hard-coded per scene/p in every reference attack
# script (attack_NeRFail.py:170-187, attack_NeRFail_S.py:158-177).
MASK_VIEW_TABLE: Dict[int, Dict[str, Tuple[int, ...]]] = {
    2: {"default": (75, 125), "ship": (50, 100)},
    3: {"default": (50, 75, 125)},
    4: {"default": (50, 75, 100, 125), "materials": (0, 50, 75, 125)},
}

# The 8 blender scenes and their class indices in the 8-way classifier
# (reference model_test.py:49 class table; folder-scan order).
SCENE_CLASSES: Tuple[str, ...] = (
    "chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship",
)
