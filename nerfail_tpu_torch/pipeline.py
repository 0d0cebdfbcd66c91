"""Experiment pipeline: one API over the reference's hand-run stages.

Ports nerfail_tpu/pipeline.py. The reference stitches stages together
through the filesystem with naming conventions rebuilt in three places
(attack_NeRFail_S.py:97-106, model_test.py:104-128, transfer_files.py:7-74).
Here:

  * `ArtifactLayout` is the single source of truth for artifact paths and
    reproduces the reference's directory-name grammar exactly
    (`NeRFail_S_3P_100_to_n_e_32_a_2/test`, step names
    attack/nerf/defense/nerf_defense), letter for letter the JAX
    package's.
  * `Pipeline` runs the stages end to end on `device` — NeRF train →
    coord extraction → point-set build → attack → eval → NeRF inheritance
    retrain — with skip-if-exists resumability at the table stage and
    resumable attack state.

Images are written by utils/png. With a process `mesh`
(parallel/mesh.py; every rank runs the same stages) NeRF training and the
two 3D attack engines run sharded over it, as the JAX pipeline's `mesh`
does; every other stage runs whole on each rank, the 2D engines on rank 0
with the result broadcast. Rank 0 alone writes files, and the other ranks
wait at a barrier before anything reads them back.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nerfail_tpu_torch.config import (
    AttackConfig,
    ExperimentConfig,
    PointSetConfig,
    mask_views,
    scene_class_index,
)
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device
from nerfail_tpu_torch.utils.png import imwrite

STEP_NAMES = {0: "attack", 1: "nerf", 2: "defense", 3: "nerf_defense"}


@dataclass
class ArtifactLayout:
    """Path grammar for every stage artifact under one experiment root."""

    root: str = "./output"

    # ---- NeRF stage ----
    def nerf_logdir(self, scene: str, inherit_tag: Optional[str] = None) -> str:
        tag = f"_{inherit_tag}" if inherit_tag else ""
        return os.path.join(self.root, "nerf_logs", f"{scene}{tag}")

    def coords_dir(self, scene: str) -> str:
        return os.path.join(self.root, "spatial_point_set", scene, "coords")

    def tables_path(self, scene: str, p: int, split: str) -> str:
        return os.path.join(
            self.root, "spatial_point_set", scene,
            f"index_and_weight_{p}P_{split}.npz",
        )

    # ---- classifier stage ----
    def classifier_dir(self, model_name: str) -> str:
        return os.path.join(self.root, "classifiers", model_name)

    def classifier_best(self, model_name: str) -> str:
        return os.path.join(self.classifier_dir(model_name), "best.ckpt")

    # ---- attack stage: the reference grammar ----
    def attack_method_dirname(
        self,
        method: str,
        acfg: AttackConfig,
        target: Optional[int] = None,
    ) -> str:
        """`NeRFail_3P_100_to_n_e_32_m_8_100` etc. (transfer_files.py:33-57)."""
        to = str(target) if target is not None else (
            str(acfg.target_label) if acfg.targeted else "n"
        )
        e = _fmt_num(acfg.eps)
        a = _fmt_num(acfg.a)
        m1 = _fmt_num(acfg.m1)
        m2 = _fmt_num(acfg.m2)
        ep = acfg.attack_epochs
        p = acfg.base_mask_number
        if method == "NeRFail":
            return f"NeRFail_{p}P_{ep}_to_{to}_e_{e}_m_{m1}_{m2}"
        if method == "NeRFail_S":
            return f"NeRFail_S_{p}P_{ep}_to_{to}_e_{e}_a_{a}"
        if method == "IGSM_2D":
            return f"IGSM_2D_{ep}_to_{to}_e_{e}_a_{a}"
        if method == "Universal_2D":
            return f"Universal_2D_{ep}_to_{to}_e_{e}_m_{m1}_{m2}"
        if method == "No_attack":
            return "no_attack"
        raise ValueError(f"unknown method {method}")

    def attack_dir(
        self,
        model_name: str,
        scene: str,
        method: str,
        acfg: AttackConfig,
        step: int = 0,
        split: Optional[str] = None,
    ) -> str:
        d = os.path.join(
            self.root, model_name, STEP_NAMES[step], scene,
            self.attack_method_dirname(method, acfg),
        )
        return os.path.join(d, split) if split else d

    def attack_masks_dir(self, attack_dir: str, split: str) -> str:
        return os.path.join(attack_dir, "attack_masks", split)

    def eval_report_path(self, attack_dir: str, split: str) -> str:
        return os.path.join(attack_dir, f"eval_{split}.json")


def _fmt_num(x: float) -> str:
    return str(int(x)) if float(x).is_integer() else str(x)


def _to8(x: np.ndarray) -> np.ndarray:
    return np.clip(x, 0, 255).astype(np.uint8)


def save_attacked_images(
    out_dir: str,
    attacked_rgba: np.ndarray,      # [N, H, W, 4] 0-255
    masks: Optional[np.ndarray] = None,      # [N, H, W, 4] splat masks
    originals: Optional[np.ndarray] = None,  # [N, H, W, 4]
    indices: Optional[Sequence[int]] = None,
) -> None:
    """Write r_<i>.png (+ mask + _ori) like the attack scripts' final epoch
    (attack_NeRFail.py:420-431)."""
    os.makedirs(out_dir, exist_ok=True)
    n = attacked_rgba.shape[0]
    idxs = list(indices) if indices is not None else list(range(n))
    for j, i in enumerate(idxs):
        imwrite(os.path.join(out_dir, f"r_{i}.png"), _to8(attacked_rgba[j]))
        if originals is not None:
            imwrite(os.path.join(out_dir, f"r_{i}_ori.png"),
                    _to8(originals[j]))
    if masks is not None:
        mask_dir = os.path.join(os.path.dirname(out_dir), "attack_masks",
                                os.path.basename(out_dir))
        os.makedirs(mask_dir, exist_ok=True)
        for j, i in enumerate(idxs):
            imwrite(os.path.join(mask_dir, f"r_{i}.png"), _to8(masks[j]))


def _write_report(report: Dict, report_path: Optional[str]) -> None:
    if report_path:
        os.makedirs(os.path.dirname(report_path), exist_ok=True)
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)


@dataclass
class Pipeline:
    """End-to-end experiment runner with stage-level resumability; every
    stage runs on `device` (the mesh's device when a `mesh` is set)."""

    layout: ArtifactLayout
    cfg: ExperimentConfig
    pcfg: PointSetConfig = field(default_factory=PointSetConfig)
    device: DeviceLike = "cuda"
    # parallel.mesh.Mesh; when set, the train and attack stages run their
    # steps sharded over it (data-parallel rays / views × the MLP width)
    mesh: Optional[Any] = None

    def __post_init__(self):
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(self.device))

    @property
    def writer(self) -> bool:
        """Whether this rank writes files (rank 0, or a run without mesh)."""
        return self.mesh is None or self.mesh.is_writer

    def _wait(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    # ---------------- stage 1: NeRF ----------------
    def stage_train_nerf(self, scene_data, scene_name: str, n_iters=None,
                         inherit_tag: Optional[str] = None,
                         train_images: Optional[np.ndarray] = None,
                         ft_path: Optional[str] = None):
        """Train (or resume) the scene NeRF; returns final state."""
        from nerfail_tpu_torch.data.blender import white_background_composite
        from nerfail_tpu_torch.train.nerf_trainer import train_nerf

        logdir = self.layout.nerf_logdir(scene_name, inherit_tag)
        targets = white_background_composite(scene_data.images)
        if train_images is not None:
            # perturbation inheritance: swap train images (load_blender.py:62)
            targets = targets.copy()
            targets[scene_data.i_train] = train_images
        return train_nerf(
            self.cfg, targets, scene_data.poses, scene_data.K,
            scene_data.i_train, logdir=logdir, n_iters=n_iters,
            ft_path=ft_path, device=self.device, mesh=self.mesh,
        )

    # ---------------- stage 2: point set ----------------
    def stage_pointset(self, state, scene_data, scene_name: str,
                       splits: Dict[str, np.ndarray],
                       p: Optional[int] = None):
        """coord maps for every split + S from the mask views + tables.

        splits: {"test": pose_indices, "train": ..., "val": ...}
        Returns ({split: (weights, idx)}, S). Skips any split whose table
        file already exists. The renders run K4 on the card, the tables K3.
        """
        from nerfail_tpu_torch.pointset.extract import (
            build_neighbor_tables,
            build_point_set,
            extract_coord_maps,
        )

        p = p or 3
        mask_ids = np.asarray(mask_views(scene_name, p))
        # mask views index into the TEST split by convention
        mask_pose_ids = splits["test"][mask_ids]

        coords_mask, _ = extract_coord_maps(
            state.params, self.cfg, scene_data.poses[mask_pose_ids],
            scene_data.H, scene_data.W, scene_data.K,
        )
        S = build_point_set(coords_mask)

        paths = {split: self.layout.tables_path(scene_name, p, split)
                 for split in splits}
        # every rank decides what exists before rank 0 writes anything
        done = {split: os.path.exists(path) for split, path in paths.items()}
        self._wait()
        out = {}
        for split, ids in splits.items():
            path = paths[split]
            if done[split]:
                data = np.load(path)
                out[split] = (data["weights"], data["idx"])
                continue
            coords, _ = extract_coord_maps(
                state.params, self.cfg, scene_data.poses[ids],
                scene_data.H, scene_data.W, scene_data.K,
            )
            out[split] = build_neighbor_tables(
                coords, S, self.pcfg, save_path=path if self.writer else None,
                device=self.device
            )
        self._wait()
        return out, S

    # ---------------- stage 3: attack ----------------
    def stage_attack(
        self,
        method: str,
        acfg: AttackConfig,
        scene_name: str,
        model_name: str,
        logits_fn,
        resize_to: Optional[int],
        ori_images: np.ndarray,          # [N, H, W, 4] 0-255 views to attack
        tables: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        mask_images: Optional[np.ndarray] = None,   # [p, H, W, 4]
        epochs: Optional[int] = None,
        save: bool = True,
        indices: Optional[Sequence[int]] = None,
        split: str = "test",
        checkpoint: bool = True,
        checkpoint_every: int = 1,
    ):
        """Run one attack engine, write artifacts, return AttackResult.

        With `checkpoint` (default), in-flight attack state persists to
        `<method_dir>/attack_state.npz` every `checkpoint_every` epochs so
        a preempted 100-epoch run resumes instead of restarting; the
        engine removes it when the run ends. Under a `mesh` NeRFail and
        NeRFail-S run sharded; the 2D engines run on rank 0 and every rank
        gets its result.
        """
        from nerfail_tpu_torch.attacks.forward import zero_init_mask
        from nerfail_tpu_torch.attacks.igsm2d import igsm_2d_attack
        from nerfail_tpu_torch.attacks.nerfail import nerfail_attack
        from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
        from nerfail_tpu_torch.attacks.uap2d import uap_2d_attack

        labels = np.full(ori_images.shape[0], scene_class_index(scene_name),
                         np.int64)
        method_dir = self.layout.attack_dir(
            model_name, scene_name, method, acfg, step=0
        )
        kw = {"checkpoint_path": (os.path.join(method_dir, "attack_state.npz")
                                  if checkpoint else None),
              "checkpoint_every": checkpoint_every,
              "resize_to": resize_to, "epochs": epochs,
              "device": self.device}

        if method in ("NeRFail", "NeRFail_S"):
            if tables is None or mask_images is None:
                raise ValueError(f"{method} needs the tables and mask images")
            weights, idx = tables
            delta0 = zero_init_mask(np.asarray(mask_images, np.float32))
            delta0 = delta0.numpy()
            if method == "NeRFail_S":
                result = nerfail_s_attack(
                    delta0, weights, idx, ori_images, labels, logits_fn,
                    acfg, mesh=self.mesh, **kw,
                )
            else:
                result = nerfail_attack(
                    delta0, weights, idx, ori_images, logits_fn, acfg,
                    mesh=self.mesh, **kw,
                )
        elif method in ("IGSM_2D", "Universal_2D"):
            result = None
            if self.writer:
                if method == "IGSM_2D":
                    result = igsm_2d_attack(ori_images, labels, logits_fn,
                                            acfg, **kw)
                else:
                    result = uap_2d_attack(ori_images, logits_fn, acfg, **kw)
            if self.mesh is not None:
                result = self.mesh.broadcast_object(result)
        else:
            raise ValueError(f"unknown method {method}")

        if save:
            attacked, masks = self.render_attacked(
                method, result.delta, ori_images, tables, acfg, resize_to,
                logits_fn,
            )
            out_dir = self.layout.attack_dir(
                model_name, scene_name, method, acfg, step=0, split=split
            )
            if self.writer:
                save_attacked_images(
                    out_dir, attacked, masks=masks, originals=ori_images,
                    indices=indices,
                )
                # the raw perturbation tensor: `universal.npy` mirrors the
                # reference's universal.pth (attack_UAP_2D.py:363); the
                # other methods save theirs as delta.npy
                name = ("universal.npy" if method == "Universal_2D"
                        else "delta.npy")
                np.save(os.path.join(os.path.dirname(out_dir), name),
                        result.delta)
            self._wait()
        return result

    @torch.no_grad()
    def render_attacked(self, method, delta, ori_images, tables, acfg,
                        resize_to, logits_fn, batch_size: int = 16):
        """Apply a final perturbation to views → (attacked_rgba, masks) as
        numpy. Processed in view batches so full-resolution splits
        (100×800²×8 neighbor tables) stay within device memory."""
        from nerfail_tpu_torch.attacks.forward import (
            splat_attack_forward, universal_2d_forward,
        )

        dev = self.device
        n = ori_images.shape[0]
        if method in ("NeRFail", "NeRFail_S"):
            weights, idx = tables
            delta_d = torch.as_tensor(np.asarray(delta, np.float32),
                                      device=dev).reshape(-1, 4)
            att, masks = [], []
            for s in range(0, n, batch_size):
                b = slice(s, s + batch_size)
                out = splat_attack_forward(
                    delta_d, weights[b], idx[b],
                    np.asarray(ori_images[b], np.float32), logits_fn,
                    eps=acfg.eps, resize_to=resize_to, device=dev,
                )
                att.append(out["attacked_rgba"].cpu().numpy())
                masks.append(out["splat"].cpu().numpy())
            return np.concatenate(att), np.concatenate(masks)
        att = []
        delta = np.asarray(delta, np.float32)
        for s in range(0, n, batch_size):
            b = slice(s, s + batch_size)
            d = delta[b] if delta.ndim == 4 else delta
            out = universal_2d_forward(
                d, np.asarray(ori_images[b], np.float32), logits_fn,
                resize_to=resize_to, device=dev,
            )
            att.append(out["attacked_rgb"].cpu().numpy())
        rgb = np.concatenate(att)
        return np.concatenate([rgb, ori_images[..., 3:4]], axis=-1), None

    # ---------------- stage 3b: defense fine-tune ----------------
    def stage_defense_finetune(
        self, model, clean_images, clean_labels, attacked_images,
        attacked_labels, epochs: int = 20, batch_size: int = 16,
        lr: float = 1e-4,
    ):
        """Adversarial fine-tune: continue classifier training on a clean +
        attacked mixture, SGD(lr, momentum 0.9) as optax.sgd. The
        reference only *names* the defense steps (model_test.py:77-79) —
        evaluating a defended model on the same artifacts; this stage
        produces such a model. Each epoch's order and the model's own
        draws (dropout) come from generators seeded by 0, as the JAX
        stage seeds its own. Returns the model, trained in place."""
        from nerfail_tpu_torch.train.classifier_trainer import (
            make_classifier_train_step,
        )

        dev = self.device
        model.to(dev)
        X = torch.as_tensor(np.concatenate([clean_images, attacked_images]),
                            dtype=torch.float32, device=dev)
        y = torch.as_tensor(np.concatenate([clean_labels, attacked_labels]),
                            dtype=torch.int64, device=dev)
        optimizer = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9,
                                    dampening=0.0)
        step_fn = make_classifier_train_step(model, optimizer)
        n = X.shape[0]
        order = torch.Generator().manual_seed(0)
        with torch.random.fork_rng(
                devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(0)
            for _ in range(epochs):
                perm = torch.randperm(n, generator=order)
                perm = perm[: n // batch_size * batch_size].to(dev)
                for b in perm.view(-1, batch_size):
                    step_fn(X[b], y[b])
        return model

    # ---------------- stage 3c: perturbation inheritance ----------------
    def stage_inherit(
        self,
        scene_data,
        scene_name: str,
        method: str,
        acfg: AttackConfig,
        model_name: str,
        logits_fn,
        resize_to: Optional[int],
        delta: np.ndarray,
        tables: Dict[str, Tuple[np.ndarray, np.ndarray]],
        n_iters: Optional[int] = None,
        eval_splits: Sequence[str] = ("test",),
        render_factor: int = 0,
    ):
        """Close the attack→NeRF inheritance loop (SURVEY §3.5 round-trip).

        One call chains what the reference runs by hand across four scripts
        (run_nerf.py --train_dir → nerf_render_only.py → transfer_files.py →
        model_test.py --step 1):
          1. apply the final perturbation to the TRAIN views and persist
             them in the step-0 artifact dir,
          2. retrain the scene NeRF on the attacked train set (K4/K5),
          3. render train/test/val from the retrained checkpoint straight
             into the step-1 ("nerf") artifact dir (K4),
          4. evaluate the step-1 renders against the clean views.

        Returns (retrained_state, {split: eval report}).
        """
        from nerfail_tpu_torch.data.blender import white_background_composite
        from nerfail_tpu_torch.data.datasets import (
            rgba_to_white_rgb, scene_views_dataset,
        )
        from nerfail_tpu_torch.render_path import render_path

        # 1. attacked train views → step-0 train dir
        ori_train = scene_views_dataset(
            scene_data.images[scene_data.i_train]
        )
        attacked_train, _ = self.render_attacked(
            method, delta, ori_train, tables.get("train"), acfg,
            resize_to, logits_fn,
        )
        train_dir = self.layout.attack_dir(
            model_name, scene_name, method, acfg, step=0, split="train"
        )
        if self.writer:
            save_attacked_images(train_dir, attacked_train,
                                 originals=ori_train)
        self._wait()

        # 2. retrain on the attacked set (run_nerf.py --train_dir)
        inherit_tag = (
            f"{model_name}_{self.layout.attack_method_dirname(method, acfg)}"
        )
        targets01 = rgba_to_white_rgb(attacked_train) / 255.0
        state = self.stage_train_nerf(
            scene_data, scene_name, n_iters=n_iters,
            inherit_tag=inherit_tag, train_images=targets01,
        )

        # 3+4. render all splits into the step-1 dir; evaluate
        splits = {
            "train": scene_data.i_train,
            "val": scene_data.i_val,
            "test": scene_data.i_test,
        }
        reports: Dict[str, Dict] = {}
        for split, ids in splits.items():
            out_dir = self.layout.attack_dir(
                model_name, scene_name, method, acfg, step=1, split=split
            )
            rgbs, _ = render_path(
                state.params, self.cfg, scene_data.poses[ids],
                scene_data.H, scene_data.W, scene_data.K,
                save_dir=out_dir if self.writer else None,
                render_factor=render_factor,
            )
            if split in eval_splits:
                rendered = np.clip(rgbs * 255.0, 0, 255).astype(np.float32)
                clean = np.clip(
                    white_background_composite(scene_data.images[ids])
                    * 255.0, 0, 255,
                ).astype(np.float32)
                if render_factor > 0:
                    clean = clean[:, ::render_factor, ::render_factor]
                reports[split] = self.stage_eval(
                    logits_fn, rendered, clean, scene_name,
                    report_path=self.layout.eval_report_path(
                        self.layout.attack_dir(
                            model_name, scene_name, method, acfg, step=1
                        ),
                        split,
                    ),
                    resize_to=resize_to,
                )
        self._wait()
        return state, reports

    # ---------------- stage 4: eval ----------------
    def stage_eval_full(
        self,
        logits_fn,
        data_root: str,
        split: str,
        scene_name: str,
        override_dir: Optional[str] = None,
        ori_dir: Optional[str] = None,
        resize_to: Optional[int] = None,
        report_path: Optional[str] = None,
        annotate_dir: Optional[str] = None,
    ):
        """Full 8-class test (model_test.py:41-421): per-class loss/acc,
        ASR + misclass table + perturbation stats for the attacked class
        (whose images come from `override_dir`), optional annotated dump."""
        from nerfail_tpu_torch.data.datasets import load_classifier_split
        from nerfail_tpu_torch.eval.harness import evaluate_testset

        ds = load_classifier_split(
            data_root, split, resize_to,
            override_dir=override_dir, override_class=scene_name,
            ori_dir=ori_dir,
        )
        report = evaluate_testset(
            logits_fn, ds.images, ds.labels,
            attacked_class=scene_class_index(scene_name),
            original_images=ds.ori_images,
            annotate_dir=annotate_dir if self.writer else None,
            indices=ds.indices, device=self.device,
        )
        if self.writer:
            _write_report(report, report_path)
        self._wait()
        return report

    def stage_eval(self, logits_fn, attacked_rgba, ori_images, scene_name,
                   report_path: Optional[str] = None, resize_to=None):
        """evaluate_attack on white-composited views resized on the
        device, 16 views at a time."""
        from nerfail_tpu_torch.attacks.forward import resize_batch
        from nerfail_tpu_torch.data.datasets import rgba_to_white_rgb
        from nerfail_tpu_torch.eval.harness import evaluate_attack

        def prep(x):
            x = rgba_to_white_rgb(np.asarray(x, np.float32))
            if not resize_to:
                return x
            with torch.no_grad():
                return np.concatenate([
                    resize_batch(torch.as_tensor(x[s:s + 16],
                                                 device=self.device),
                                 resize_to).cpu().numpy()
                    for s in range(0, x.shape[0], 16)])

        report = evaluate_attack(
            logits_fn, prep(attacked_rgba), prep(ori_images),
            true_label=scene_class_index(scene_name), device=self.device,
        )
        if self.writer:
            _write_report(report, report_path)
        self._wait()
        return report
