"""Typed configuration: NeRF model, rendering, training, scene, point set
and attack knobs, the reference's scene tables, and the loader for its
`key = value` config files.

Field names, defaults and table contents are those of `nerfail_tpu.config`,
so one configuration (or config file) means the same thing to both
packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class NeRFModelConfig:
    """Architecture of one NeRF MLP (reference run_nerf_helpers.py:71-123)."""

    netdepth: int = 8
    netwidth: int = 256
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True
    multires: int = 10        # positional-encoding freqs for xyz → 63 ch
    multires_views: int = 4   # for view dirs → 27 ch
    i_embed: int = 0          # 0 = fourier encoding, -1 = identity
    # Positive shift on the density-head bias at init: with the plain
    # U(±1/√fan_in) init raw σ can start negative everywhere, and relu(σ)
    # then has zero gradient (the reference's "PSNR stuck" pathology).
    density_init_bias: float = 0.5

    @property
    def input_ch(self) -> int:
        return 3 if self.i_embed == -1 else 3 * (1 + 2 * self.multires)

    @property
    def input_ch_views(self) -> int:
        if not self.use_viewdirs:
            return 0
        return 3 if self.i_embed == -1 else 3 * (1 + 2 * self.multires_views)

    @property
    def output_ch(self) -> int:
        # rgb + sigma; the reference's fifth channel is never used
        return 4


@dataclass(frozen=True)
class RenderConfig:
    """Sampling + compositing options (reference render_rays run_nerf.py:308).

    `use_pallas` keeps the JAX package's name so that one config file means
    the same to both packages. True selects the fused encoding + MLP
    (`ops/cuda/mlp_kernel.py`: the K4/K5 kernels on CUDA tensors, their
    bf16 plain versions on CPU tensors) wherever the model has the viewdir
    head; False selects the unfused f32 `positional_encoding` +
    `apply_nerf` path, which the reference goldens use. None means what it
    means in the reference, "auto": the fused kernels only on CUDA tensors,
    for a model with the viewdir head that `MlpDims.from_cfg` accepts (the
    Fourier encoding, depth ≤ 16, width a multiple of 32 up to 256), and
    the unfused f32 path otherwise, on every CPU tensor included.
    """

    N_samples: int = 64
    N_importance: int = 128
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    white_bkgd: bool = True
    lindisp: bool = False
    ndc: bool = False
    near: float = 2.0
    far: float = 6.0
    chunk: int = 32768        # rays per render chunk (run_nerf.py:449-451)
    use_pallas: Optional[bool] = None


@dataclass(frozen=True)
class TrainConfig:
    """NeRF optimization schedule (reference run_nerf.py:537-888)."""

    N_rand: int = 1024
    lrate: float = 5e-4
    lrate_decay: int = 500          # lr·0.1^(step/(decay·1000)), run_nerf.py:796-800
    N_iters: int = 200000
    precrop_iters: int = 500
    precrop_frac: float = 0.5
    no_batching: bool = True        # sample rays from a single image per step
    i_print: int = 100
    i_weights: int = 10000
    i_testset: int = 50000
    i_video: int = 50000


@dataclass(frozen=True)
class SceneConfig:
    """Dataset selection (reference config files + load_blender.py)."""

    datadir: str = "data/nerf_synthetic/lego"
    dataset_type: str = "blender"
    expname: str = "lego"
    basedir: str = "./logs"
    half_res: bool = False
    testskip: int = 8
    train_dir: Optional[str] = None   # swap train imgs with attacked set
    # llff-only
    factor: int = 8
    spherify: bool = False
    llffhold: int = 8
    no_ndc: bool = False


@dataclass(frozen=True)
class PointSetConfig:
    """Spatial-point-set build (reference create_index_and_dist.py:22-171)."""

    k: int = 8                 # nearest neighbors kept per pixel
    gauss_c: float = 0.02      # gaussian width (GaussNet.py:174)
    gauss_eps: float = 0.001   # weight-sum regulariser (GaussNet.py:178)
    s_chunk: int = 1200        # point-set tile per cdist step (ref: S.chunk(1600))
    q_chunk: int = 65536       # query pixels per tile


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


def load_config_file(path: str) -> Dict[str, Any]:
    """Parse the reference's `key = value` config txt format
    (configargparse, run_nerf.py:421-534): bare True/False are booleans,
    numbers parse as int then float, anything else is a string."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = (s.strip() for s in line.split("=", 1))
            if val in ("True", "true"):
                out[key] = True
            elif val in ("False", "false"):
                out[key] = False
            else:
                try:
                    out[key] = int(val)
                except ValueError:
                    try:
                        out[key] = float(val)
                    except ValueError:
                        out[key] = val
    return out


def _filter_kwargs(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kwargs.items() if k in names}


@dataclass(frozen=True)
class ExperimentConfig:
    """One fully-specified experiment: scene + model + render + train."""

    model: NeRFModelConfig = field(default_factory=NeRFModelConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    scene: SceneConfig = field(default_factory=SceneConfig)

    @staticmethod
    def from_file(path: str, **overrides: Any) -> "ExperimentConfig":
        raw = load_config_file(path)
        raw.update(overrides)
        return ExperimentConfig(
            model=NeRFModelConfig(**_filter_kwargs(NeRFModelConfig, raw)),
            render=RenderConfig(**_filter_kwargs(RenderConfig, raw)),
            train=TrainConfig(**_filter_kwargs(TrainConfig, raw)),
            scene=SceneConfig(**_filter_kwargs(SceneConfig, raw)),
        )
