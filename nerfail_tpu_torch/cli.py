"""Command-line entry points of the port.

Ports nerfail_tpu/cli.py (the reference's script surface: run_nerf.py /
nerf_to_coord.py / nerf_render_only.py / create_index_and_dist.py +
dist_to_weight.py / model_train.py / attack_*.py / model_test.py), driven
through the Pipeline API and one artifact layout, with the JAX CLI's
commands, flags and defaults:

  python -m nerfail_tpu_torch.cli train-nerf --config configs/lego.txt
  python -m nerfail_tpu_torch.cli extract-coords --config configs/lego.txt
  python -m nerfail_tpu_torch.cli train-classifier --model_name inception
  python -m nerfail_tpu_torch.cli attack --method NeRFail_S --label lego \\
      --model_name inception --e 32 --a 2
  python -m nerfail_tpu_torch.cli evaluate --method NeRFail_S --label lego
  python -m nerfail_tpu_torch.cli inherit --method NeRFail_S --label lego

Every command runs on `--device` (default cuda; `--device cpu` runs the
plain PyTorch versions). train-nerf, attack and inherit run sharded over a
process mesh, as the JAX CLI's do over a device mesh:

  python -m nerfail_tpu_torch.cli train-nerf --config configs/lego.txt \
      --num_devices 4 --model_parallel 1
  python -m nerfail_tpu_torch.cli attack ... --num_processes 8 \
      --coordinator_address host0:29500 --process_id 3

`--num_devices N` on one host runs the command in N ranks, one process
each (parallel/launch.spawn); `--num_processes` joins a process group that
spans hosts, one process per card, the command started once per process.
`--dist_backend` is nccl on cuda and gloo on cpu by default; an NCCL
request that fails raises. Checkpoints are the port's own
(train/checkpoint.py, train_classifier's best.ckpt).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from nerfail_tpu_torch.config import (
    AttackConfig,
    ExperimentConfig,
    SCENE_CLASSES,
    mask_views,
)
from nerfail_tpu_torch.pipeline import ArtifactLayout, Pipeline


def _build_cfg(args) -> ExperimentConfig:
    if args.config:
        return ExperimentConfig.from_file(args.config)
    return ExperimentConfig()


def _load_scene_and_cfg(cfg: ExperimentConfig):
    """Load the scene and resolve ndc/near/far against it (data/load.py)."""
    from nerfail_tpu_torch.data.load import load_scene

    return load_scene(cfg)


def _backend(args) -> str:
    if args.dist_backend:
        return args.dist_backend
    return "nccl" if torch.device(args.device).type == "cuda" else "gloo"


def _setup_parallel(args):
    """Process group + mesh from the CLI flags (None = one device, the
    reference's only mode — run_nerf.py:22). Under a mesh the command runs
    on the rank's device."""
    if getattr(args, "mesh", None) is not None:
        mesh = args.mesh
    else:
        mesh = None
        if getattr(args, "num_processes", None):
            from nerfail_tpu_torch.parallel.multihost import (
                initialize_distributed,
            )

            initialize_distributed(
                coordinator_address=args.coordinator_address,
                num_processes=args.num_processes,
                process_id=args.process_id,
                backend=_backend(args),
            )
        if getattr(args, "num_devices", None) or getattr(
            args, "model_parallel", None
        ):
            from nerfail_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(n_devices=args.num_devices,
                             model_parallel=args.model_parallel,
                             device=args.device)
    if mesh is not None:
        args.device = str(mesh.device)
    return mesh


def _rank_main(mesh, argv):
    """One rank of a `--num_devices` run: the command on `mesh`."""
    main(argv, mesh=mesh)


def _spawn_ranks(args, argv) -> bool:
    """Run a sharded command in `--num_devices` ranks on this host when no
    process group spans hosts; False when the command runs here."""
    import torch.distributed as dist

    if args.fn not in (cmd_train_nerf, cmd_attack, cmd_inherit):
        return False
    if not (args.num_devices or args.model_parallel):
        return False
    if args.num_processes or dist.is_initialized():
        return False
    from nerfail_tpu_torch.parallel.launch import spawn

    dev = torch.device(args.device)
    n = args.num_devices or (torch.cuda.device_count()
                             if dev.type == "cuda" else 0)
    if not n:
        raise ValueError("--model_parallel on the CPU needs --num_devices")
    spawn(_rank_main, n, backend=_backend(args), device_type=dev.type,
          model_parallel=args.model_parallel, args=(list(argv),))
    return True


def _nerf_state(cfg: ExperimentConfig, layout: ArtifactLayout, scene: str,
                device):
    from nerfail_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfail_tpu_torch.train.nerf_trainer import load_train_state

    ckpt = latest_checkpoint(layout.nerf_logdir(scene))
    if not ckpt:
        sys.exit("no NeRF checkpoint found — run train-nerf first")
    return load_train_state(ckpt, cfg, device)


def _splits(scene):
    return {"test": scene.i_test, "train": scene.i_train, "val": scene.i_val}


def cmd_train_nerf(args):
    cfg = _build_cfg(args)
    scene, cfg = _load_scene_and_cfg(cfg)
    mesh = _setup_parallel(args)
    pipe = Pipeline(ArtifactLayout(args.output), cfg, device=args.device,
                    mesh=mesh)
    state = pipe.stage_train_nerf(
        scene, cfg.scene.expname, n_iters=args.n_iters, ft_path=args.ft_path,
    )
    print(f"trained to step {state.step}")


def cmd_extract_coords(args):
    from nerfail_tpu_torch.pointset.extract import extract_coord_maps

    cfg = _build_cfg(args)
    scene, cfg = _load_scene_and_cfg(cfg)
    layout = ArtifactLayout(args.output)
    state = _nerf_state(cfg, layout, cfg.scene.expname, args.device)
    save_dir = layout.coords_dir(cfg.scene.expname)
    coords, _ = extract_coord_maps(
        state.params, cfg, scene.poses, scene.H, scene.W, scene.K,
        save_dir=save_dir, save_rgb=True,
    )
    print(f"saved {coords.shape[0]} coord maps to {save_dir}")


def cmd_render_only(args):
    """nerf_render_only.py parity: render train/test/val splits (and the
    spiral video) from the latest checkpoint into per-split dirs."""
    from nerfail_tpu_torch.render_path import render_path

    cfg = _build_cfg(args)
    scene, cfg = _load_scene_and_cfg(cfg)
    layout = ArtifactLayout(args.output)
    state = _nerf_state(cfg, layout, cfg.scene.expname, args.device)
    for split, ids in (("train", scene.i_train), ("val", scene.i_val),
                       ("test", scene.i_test)):
        out_dir = os.path.join(
            layout.root, "renders", cfg.scene.expname,
            f"renderonly_{split}_{state.step - 1:06d}",
        )
        render_path(
            state.params, cfg, scene.poses[ids], scene.H, scene.W,
            scene.K, save_dir=out_dir, render_factor=args.render_factor,
            save_coords=not args.only_render_img,
        )
        print(f"{split}: {len(ids)} renders -> {out_dir}")
    if args.video:
        video = os.path.join(
            layout.root, "renders", cfg.scene.expname, "spiral.mp4"
        )
        render_path(
            state.params, cfg, scene.render_poses, scene.H, scene.W,
            scene.K, render_factor=max(args.render_factor, 2),
            video_path=video,
        )
        print(f"video -> {video}")


def cmd_invert_disturbance(args):
    from nerfail_tpu_torch.utils.disturbance import invert_disturbance_file

    invert_disturbance_file(args.input, args.out)
    print(f"wrote {args.out}")


def cmd_train_classifier(args):
    from nerfail_tpu_torch.data.datasets import load_classifier_split
    from nerfail_tpu_torch.models.classifiers.registry import (
        classifier_input_size, get_classifier,
    )
    from nerfail_tpu_torch.train.classifier_trainer import train_classifier

    size = classifier_input_size(args.model_name)
    train = load_classifier_split(args.datadir, "train", size)
    val = load_classifier_split(args.datadir, "val", size)
    torch.manual_seed(0)
    model = get_classifier(args.model_name)
    layout = ArtifactLayout(args.output)
    train_classifier(
        model, train.images, train.labels, val.images, val.labels,
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        logdir=layout.classifier_dir(args.model_name),
        log_fn=lambda e, m: print(f"epoch {e}: {m}"), device=args.device,
    )
    print("done")


def _attack_cfg_from_args(args) -> AttackConfig:
    return AttackConfig(
        method=args.method, eps=args.e, a=args.a, m1=args.m1, m2=args.m2,
        attack_epochs=args.attack_epochs, targeted=args.targeted,
        target_label=args.attack_target_label_int,
        base_mask_number=args.base_mask_image_number,
        view_batch=getattr(args, "view_batch", 1),
    )


def _classifier_logits(args, layout):
    from nerfail_tpu_torch.attacks.forward import make_classifier_logits_fn
    from nerfail_tpu_torch.models.classifiers.registry import (
        classifier_input_size, get_classifier,
    )
    from nerfail_tpu_torch.train.classifier_trainer import load_classifier

    model = load_classifier(layout.classifier_best(args.model_name),
                            get_classifier(args.model_name), args.device)
    return (make_classifier_logits_fn(model),
            classifier_input_size(args.model_name))


def cmd_attack(args):
    from nerfail_tpu_torch.data.datasets import scene_views_dataset

    cfg = _build_cfg(args)
    scene, cfg = _load_scene_and_cfg(cfg)
    layout = ArtifactLayout(args.output)
    mesh = _setup_parallel(args)
    pipe = Pipeline(layout, cfg, device=args.device, mesh=mesh)
    acfg = _attack_cfg_from_args(args)
    logits_fn, size = _classifier_logits(args, layout)

    tables = mask_images = None
    if args.method in ("NeRFail", "NeRFail_S"):
        # point-set stage from the scene's NeRF
        state = _nerf_state(cfg, layout, args.label, args.device)
        tables_all, _ = pipe.stage_pointset(
            state, scene, args.label, _splits(scene),
            p=acfg.base_mask_number,
        )
        tables = tables_all["test"]
        mv = np.asarray(mask_views(args.label, acfg.base_mask_number))
        mask_images = scene_views_dataset(scene.images[scene.i_test[mv]])

    ori = scene_views_dataset(scene.images[scene.i_test])
    result = pipe.stage_attack(
        args.method, acfg, args.label, args.model_name, logits_fn, size,
        ori, tables=tables, mask_images=mask_images,
        epochs=args.attack_epochs, indices=list(range(len(scene.i_test))),
    )
    print(f"best attack acc: {result.best_attack_acc:.3f}")

    attacked, _ = pipe.render_attacked(
        args.method, result.delta, ori, tables, acfg, size, logits_fn
    )
    report = pipe.stage_eval(
        logits_fn, attacked, ori, args.label,
        report_path=layout.eval_report_path(
            layout.attack_dir(args.model_name, args.label, args.method, acfg),
            "test",
        ),
        resize_to=size,
    )
    print(json.dumps(report, indent=2))


def cmd_evaluate(args):
    """model_test.py parity: evaluate an attack artifact dir (any step)."""
    from nerfail_tpu_torch.data.datasets import (
        _IDX_RE, _imread, rgba_to_white_rgb,
    )

    cfg = _build_cfg(args)
    layout = ArtifactLayout(args.output)
    pipe = Pipeline(layout, cfg, device=args.device)
    acfg = _attack_cfg_from_args(args)
    logits_fn, size = _classifier_logits(args, layout)

    attack_dir = layout.attack_dir(
        args.model_name, args.label, args.method, acfg,
        step=args.step, split=args.setname,
    )
    report_path = layout.eval_report_path(
        os.path.dirname(attack_dir), args.setname
    )
    if args.data_root:
        # full 8-class report with the attacked class's dir overridden
        report = pipe.stage_eval_full(
            logits_fn, args.data_root, args.setname, args.label,
            override_dir=attack_dir, ori_dir=args.ori_dir,
            resize_to=size, report_path=report_path,
            annotate_dir=(
                os.path.join(os.path.dirname(attack_dir),
                             f"annotated_{args.setname}")
                if args.annotate else None
            ),
        )
    else:
        # single-class eval from the r_<i>.png / r_<i>_ori.png pairs
        entries = []
        for name in os.listdir(attack_dir):
            m = _IDX_RE.search(name)
            if m:
                entries.append((int(m.group(1)), name))
        entries.sort()
        att, ori = [], []
        for i, name in entries:
            att.append(rgba_to_white_rgb(
                _imread(os.path.join(attack_dir, name))
            ))
            ori_path = os.path.join(attack_dir,
                                    name.replace(".png", "_ori.png"))
            if args.ori_dir:
                ori_path = os.path.join(args.ori_dir, f"r_{i}.png")
            ori.append(rgba_to_white_rgb(_imread(ori_path)))
        report = pipe.stage_eval(
            logits_fn, np.stack(att), np.stack(ori), args.label,
            report_path=report_path, resize_to=size,
        )
    print(json.dumps(report, indent=2))


def cmd_inherit(args):
    """Close the perturbation-inheritance loop: retrain the NeRF on the
    attacked train set, render all splits into the step-1 dir, re-test
    (transfer_files.py + model_test.py --step 1 in one command)."""
    cfg = _build_cfg(args)
    scene, cfg = _load_scene_and_cfg(cfg)
    layout = ArtifactLayout(args.output)
    mesh = _setup_parallel(args)
    pipe = Pipeline(layout, cfg, device=args.device, mesh=mesh)
    acfg = _attack_cfg_from_args(args)
    logits_fn, size = _classifier_logits(args, layout)

    delta_path = os.path.join(
        layout.attack_dir(args.model_name, args.label, args.method, acfg,
                          step=0),
        "delta.npy",
    )
    if not os.path.exists(delta_path):
        sys.exit(f"no saved perturbation at {delta_path} — run attack first")
    delta = np.load(delta_path)

    # point-set tables for the train (and eval) splits from the ORIGINAL NeRF
    state = _nerf_state(cfg, layout, args.label, args.device)
    tables, _ = pipe.stage_pointset(
        state, scene, args.label, _splits(scene), p=acfg.base_mask_number
    )
    _, reports = pipe.stage_inherit(
        scene, args.label, args.method, acfg, args.model_name,
        logits_fn, size, delta, tables, n_iters=args.n_iters,
        render_factor=args.render_factor,
    )
    print(json.dumps(reports, indent=2))


def main(argv=None, mesh=None):
    """Parse `argv` and run its command; `mesh` is given to the ranks of a
    `--num_devices` run."""
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(prog="nerfail_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--config", default=None)
    common.add_argument("--output", default="./output")
    common.add_argument("--device", default="cuda",
                        help="torch device (cuda, cuda:1, cpu)")
    # multi-chip / multi-host flags of the JAX CLI (train-nerf, attack and
    # inherit run sharded), and the collectives' backend
    common.add_argument("--num_devices", type=int, default=None,
                        help="shard over this many devices (ranks)")
    common.add_argument("--model_parallel", type=int, default=None,
                        help="tensor-parallel factor")
    common.add_argument("--coordinator_address", default=None,
                        help="host:port of rank 0 (multi-host)")
    common.add_argument("--num_processes", type=int, default=None)
    common.add_argument("--process_id", type=int, default=None)
    common.add_argument("--dist_backend", default=None,
                        choices=["nccl", "gloo"],
                        help="collectives (default nccl on cuda, gloo on "
                             "cpu)")

    sp = sub.add_parser("train-nerf", parents=[common])
    sp.add_argument("--n_iters", type=int, default=None)
    sp.add_argument("--ft_path", default=None,
                    help="explicit checkpoint to restore (run_nerf.py:218)")
    sp.set_defaults(fn=cmd_train_nerf)

    sp = sub.add_parser("extract-coords", parents=[common])
    sp.set_defaults(fn=cmd_extract_coords)

    sp = sub.add_parser("render-only", parents=[common])
    sp.add_argument("--render_factor", type=int, default=0)
    sp.add_argument("--only_render_img", action="store_true")
    sp.add_argument("--video", action="store_true")
    sp.set_defaults(fn=cmd_render_only)

    sp = sub.add_parser("invert-disturbance")
    sp.add_argument("--input", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_invert_disturbance)

    sp = sub.add_parser("train-classifier", parents=[common])
    sp.add_argument("--model_name", required=True)
    sp.add_argument("--datadir", default="data/nerf_synthetic")
    sp.add_argument("--epochs", type=int, default=200)
    sp.add_argument("--batch_size", type=int, default=16)
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.set_defaults(fn=cmd_train_classifier)

    # shared attack identity flags (method/params name the artifact dir)
    atk = argparse.ArgumentParser(add_help=False)
    atk.add_argument("--method", default="NeRFail",
                     choices=["NeRFail", "NeRFail_S", "IGSM_2D",
                              "Universal_2D"])
    atk.add_argument("--label", default="lego", choices=list(SCENE_CLASSES))
    atk.add_argument("--model_name", default="inception")
    atk.add_argument("--e", type=float, default=32.0)
    atk.add_argument("--a", type=float, default=2.0)
    atk.add_argument("--m1", type=float, default=8.0)
    atk.add_argument("--m2", type=float, default=100.0)
    atk.add_argument("--attack_epochs", type=int, default=100)
    atk.add_argument("--targeted_attack", dest="targeted",
                     action="store_true")
    atk.add_argument("--attack_target_label_int", type=int, default=0)
    atk.add_argument("--base_mask_image_number", type=int, default=3)

    sp = sub.add_parser("attack", parents=[common, atk])
    sp.add_argument("--view_batch", type=int, default=1,
                    help="views per concurrent DeepFool step (NeRFail)")
    sp.set_defaults(fn=cmd_attack)

    sp = sub.add_parser("evaluate", parents=[common, atk])
    sp.add_argument("--step", type=int, default=0,
                    choices=[0, 1, 2, 3],
                    help="artifact step: attack/nerf/defense/nerf_defense")
    sp.add_argument("--setname", default="test", choices=["test", "val"])
    sp.add_argument("--data_root", default=None,
                    help="8-class dataset root for the full per-class report")
    sp.add_argument("--ori_dir", default=None,
                    help="clean originals dir (default: r_<i>_ori.png pairs)")
    sp.add_argument("--annotate", action="store_true",
                    help="dump prediction-annotated images")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("inherit", parents=[common, atk])
    sp.add_argument("--n_iters", type=int, default=None,
                    help="retrain iterations (default: config N_iters)")
    sp.add_argument("--render_factor", type=int, default=0)
    sp.set_defaults(fn=cmd_inherit)

    args = p.parse_args(argv)
    args.mesh = mesh
    if mesh is None and _spawn_ranks(args, argv):
        return
    args.fn(args)


if __name__ == "__main__":
    main()
