"""Dataset-type dispatch + render-geometry resolution (nerfail_tpu/data/load.py).

Mirrors the per-type branches of the reference's train()
(run_nerf.py:553-636): each dataset type picks its own near/far planes —
and, for forward-facing LLFF, the NDC reparameterization — at load time:

  blender    near/far = 2/6, white_bkgd per config  (run_nerf.py:608-613)
  llff       ndc unless no_ndc/spherify; ndc → near/far = 0/1, else
             0.9·bds.min() / 1.0·bds.max()          (run_nerf.py:598-607)
  deepvoxels near/far = hemi_R ∓ 1                  (run_nerf.py:615-621)
  LINEMOD    near/far + K from the transforms json  (run_nerf.py:585-596)

Everything is normalized into a `BlenderScene` (poses as [N,4,4], one
image stack, i_split) and the experiment's RenderConfig is *resolved*
against the data — callers get back a cfg whose ndc/near/far match what
the loaders decided, so the train step / renderer / pipeline all agree.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from nerfail_tpu_torch.config import ExperimentConfig
from nerfail_tpu_torch.data.blender import BlenderScene, load_blender_data


def _poses_3x5_to_4x4(poses: np.ndarray) -> np.ndarray:
    """LLFF [N, 3, 5] (pose+hwf) → [N, 4, 4] c2w."""
    n = poses.shape[0]
    out = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
    out[:, :3, :4] = poses[:, :3, :4]
    return out


def load_scene(cfg: ExperimentConfig) -> Tuple[BlenderScene, ExperimentConfig]:
    """Load cfg.scene's dataset and resolve the render geometry.

    Returns (scene, cfg') where cfg'.render carries the ndc/near/far (and
    white_bkgd for LLFF) the dataset type dictates.
    """
    sc = cfg.scene
    r = cfg.render

    if sc.dataset_type == "blender":
        scene = load_blender_data(
            sc.datadir, half_res=sc.half_res, testskip=sc.testskip,
            train_dir=sc.train_dir,
        )
        render = dataclasses.replace(r, ndc=False, near=2.0, far=6.0)

    elif sc.dataset_type == "synthetic_box":
        from nerfail_tpu_torch.data.synthetic import make_box_scene

        scene = make_box_scene()
        render = dataclasses.replace(r, ndc=False, near=2.0, far=6.0)

    elif sc.dataset_type == "llff":
        from nerfail_tpu_torch.data.llff import load_llff_data

        ll = load_llff_data(
            sc.datadir, factor=sc.factor, spherify=sc.spherify,
        )
        poses = _poses_3x5_to_4x4(ll.poses)
        render_poses = _poses_3x5_to_4x4(ll.render_poses)
        n = poses.shape[0]
        if sc.llffhold > 0:
            i_test = np.arange(n)[:: sc.llffhold]     # run_nerf.py:600-603
        else:
            i_test = np.array([ll.i_test])
        i_val = i_test
        i_train = np.array(
            [i for i in range(n) if i not in set(i_test.tolist())]
        )
        ndc = not sc.no_ndc and not sc.spherify
        if ndc:
            near, far = 0.0, 1.0
        else:
            near = float(ll.bds.min()) * 0.9
            far = float(ll.bds.max()) * 1.0
        scene = BlenderScene(
            images=ll.images, poses=poses, render_poses=render_poses,
            H=ll.H, W=ll.W, focal=ll.focal,
            i_split=[i_train, i_val, i_test],
        )
        # llff renders real photographs — never white background
        # (the reference's llff configs leave white_bkgd at its False
        # default, run_nerf.py:607)
        render = dataclasses.replace(
            r, ndc=ndc, near=near, far=far, white_bkgd=False,
        )

    elif sc.dataset_type == "deepvoxels":
        from nerfail_tpu_torch.data.deepvoxels import load_dv_data

        dv = load_dv_data(
            scene=sc.expname, basedir=sc.datadir, testskip=sc.testskip,
        )
        hemi_r = float(
            np.mean(np.linalg.norm(dv.poses[:, :3, 3], axis=-1))
        )
        scene = BlenderScene(
            images=dv.images, poses=dv.poses,
            render_poses=dv.render_poses, H=dv.H, W=dv.W,
            focal=dv.focal, i_split=dv.i_split,
        )
        render = dataclasses.replace(
            r, ndc=False, near=hemi_r - 1.0, far=hemi_r + 1.0,
        )

    elif sc.dataset_type == "LINEMOD":
        from nerfail_tpu_torch.data.linemod import load_LINEMOD_data

        lm = load_LINEMOD_data(
            sc.datadir, half_res=sc.half_res, testskip=sc.testskip,
        )
        scene = BlenderScene(
            images=lm.images, poses=lm.poses,
            render_poses=lm.render_poses, H=lm.H, W=lm.W,
            focal=float(lm.K[0, 0]), i_split=lm.i_split,
            K_explicit=lm.K,
        )
        render = dataclasses.replace(
            r, ndc=False, near=lm.near, far=lm.far,
        )

    else:
        raise ValueError(f"unknown dataset_type {sc.dataset_type!r}")

    return scene, dataclasses.replace(cfg, render=render)
