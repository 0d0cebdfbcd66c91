"""NeRFail: DeepFool-based universal 3D point-set attack.

Ports nerfail_tpu/attacks/nerfail.py, a re-design of attack_NeRFail.py
(reference :28-523). Structure:

  outer loop (host): epochs over views with the reference's control plane —
    * per view: if the attacked prediction still equals the clean one, run
      margin-DeepFool through the splat and accumulate its delta into the
      shared point-set tensor (:394-408)
    * m2 ×10 escalation when >50% of recent DeepFool calls hit max_iter
      (:410-418)
    * m1 bisection over [m1_lo, m1_hi] driven by whether any view changed
      the tensor / final-epoch flags (:434-472)
    * best-tensor tracking by attack accuracy (:490-503)

  inner loop: one batched DeepFool per view batch (attacks/deepfool.
  deepfool_batch). On the engine path (`planned=True`, the default on every
  device) each iteration is one splat forward, one pullback per class
  through composite, resize and classifier, one K2 launch for every class
  norm and one K1 launch for the chosen class (ops/splat.
  splat_deepfool_engine) — the plain versions of both on the CPU. Tables
  and the batch's CSR plan live on the device under a byte budget
  (utils/device_cache).

With a process `mesh` (parallel/mesh.py) the view batch rounds up to a
multiple of the "data" axis and each rank walks DeepFool on its contiguous
share of every batch, with its own plan and no collective inside the walk
(a rank may take more iterations than another). Every value the control
plane branches on comes from a collective, so all ranks take the same
branches: the per-view predictions, DeepFool iterations and used /
complete flags are all-gathered over "data" and the summed δ step is
all-reduced. Rank 0 alone writes the checkpoint.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from nerfail_tpu_torch.attacks.checkpoint import (
    clear_attack_state, load_attack_state, save_attack_state,
)
from nerfail_tpu_torch.attacks.deepfool import deepfool_batch
from nerfail_tpu_torch.attacks.forward import (
    composite_after_splat, resize_batch, splat_attack_forward,
)
from nerfail_tpu_torch.attacks.nerfail_s import AttackResult, _take
from nerfail_tpu_torch.config import AttackConfig
from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
    CsrPlan, build_batched_csr_plan,
)
from nerfail_tpu_torch.ops.splat import splat_deepfool_engine
from nerfail_tpu_torch.parallel.shard import local_rows
from nerfail_tpu_torch.utils.device_cache import DeviceBudgetCache
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device

M2_MAX_LIMIT = 1e6            # m2 escalates ×10 only below this
PLAN_DEVICE_BUDGET = 2 << 30  # device bytes for batch tables and plans


def make_view_logits_fn(
    logits_fn: Callable, cfg: AttackConfig, resize_to: Optional[int]
):
    """(δ [p,H,W,4], w, idx, ori) → [C] attacked logits for one view."""

    def view_logits(delta, weights, idx, ori_img):
        out = splat_attack_forward(
            delta.reshape(-1, 4), weights[None], idx[None], ori_img[None],
            logits_fn, eps=cfg.eps, resize_to=resize_to, device=delta.device,
        )
        return out["logits"][0]

    return view_logits


def make_batched_deepfool(
    logits_fn: Callable,
    cfg: AttackConfig,
    resize_to: Optional[int],
    num_classes: int,
    accumulate_incomplete: bool = False,
    planned: bool = True,
    mesh=None,
):
    """Batched DeepFool over a view batch with a shared δ.

    All V views walk DeepFool simultaneously from the current δ; each
    carries its own perturbed copy of the point set ([V, M, 4]). With
    `planned=True` the iterations run splat_deepfool_engine over the
    batch's plan from build_batched_csr_plan; with `planned=False` they
    take the generic per-class jacobian through the batched splat.
    Semantics: synchronous accumulation within the batch (every view starts
    from the same δ), vs the reference's strictly sequential per-view
    accumulation (attack_NeRFail.py:341-408); view_batch=1 reproduces the
    reference order exactly.

    Returns df_batch(δ, w, idx, ori, ori_logits, active, m1, m2, plan) →
    (rot_sum, iters [V], used [V], complete [V]). The walk evaluates the
    engine max over views of min(iters + 1, df_max_iter) times.

    With a `mesh` the V views are this rank's share of the batch (the plan
    built over them) and the walk is view-local; rot_sum is all-reduced
    over "data" after it, and iters / used / complete are all-gathered to
    the whole batch's."""

    def df_batch(delta, w, i, ori, ori_logits, active, m1, m2,
                 plan: Optional[CsrPlan] = None):
        ori = ori.to(torch.float32)
        V = w.shape[0]
        M = delta.numel() // 4

        def logits_fn_b(delta_b):
            out = splat_attack_forward(
                delta_b.reshape(V, M, 4), w, i, ori, logits_fn,
                eps=cfg.eps, resize_to=resize_to, plan=plan,
                device=delta.device,
            )
            return out["logits"]

        jac_engine = None
        if planned:
            if plan is None:
                raise ValueError("planned DeepFool needs the batch's plan")

            def head(pix):
                out = composite_after_splat(pix, ori, eps=cfg.eps)
                return logits_fn(resize_batch(out["cla_x"], resize_to))

            def jac_engine(delta_b, ori_label):
                return splat_deepfool_engine(
                    head, delta_b.reshape(V, M, 4), i, w, plan,
                    num_classes, ori_label, mesh=mesh,
                )

        res = deepfool_batch(
            logits_fn_b, delta, ori_logits, num_classes=num_classes,
            max_iter=cfg.df_max_iter, m1=m1, m2=m2,
            overshoot=cfg.overshoot,
            targeted=cfg.targeted, target_label=cfg.target_label,
            jac_engine=jac_engine,
        )
        complete = res.iters < cfg.df_max_iter           # [V]
        use = active if accumulate_incomplete else active & complete
        mask = use.to(delta.dtype).view((V,) + (1,) * delta.ndim)
        rot_sum = torch.sum(mask * res.rot, dim=0)
        iters = res.iters
        if mesh is not None:
            mesh.all_reduce(rot_sum)
            flags = torch.stack([iters.to(torch.int64),
                                 use.to(torch.int64),
                                 complete.to(torch.int64)], 1)
            flags = mesh.all_gather(flags.to(mesh.comm_device))
            iters = flags[:, 0].to(res.iters.dtype)
            use, complete = flags[:, 1].bool(), flags[:, 2].bool()
        return rot_sum, iters, use, complete

    return df_batch


def nerfail_attack(
    delta0,                      # [p, H, W, 4] zero-init mask stack
    weights,                     # [N, H, W, 8]
    idx,                         # [N, H, W, 8]
    ori_imgs,                    # [N, H, W, 4] 0-255
    logits_fn: Callable,
    cfg: AttackConfig,
    resize_to: Optional[int] = 299,
    log_fn: Optional[Callable] = None,
    epochs: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    planned: bool = True,
    device: DeviceLike = "cuda",
    mesh=None,
) -> AttackResult:
    """The reference control plane over batched DeepFool, run on the host.

    Tables may be numpy arrays or tensors; each batch's slice and its
    batched CSR plan go to `device` once and stay there under
    PLAN_DEVICE_BUDGET bytes. With `checkpoint_path` the whole
    control-plane state persists every `checkpoint_every` executed epochs
    and an interrupted run resumes exactly. History entries carry the
    reference's counters plus `deepfool_iters`: for each batch that ran
    DeepFool, the iterations of each of its views (padding included). Such
    a batch evaluates the engine max over its views of min(iters + 1,
    df_max_iter) times, each one K2 and one K1 launch on the engine
    path.

    With a `mesh` (every rank calls this with the same arguments) the
    view batch rounds up to a multiple of the "data" axis, as the JAX
    package's `nerfail_attack` does; each rank evaluates and walks its
    share of every batch on `mesh.device`, and every rank returns the
    same result. Its engine launches count its own views' iterations."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    n = ori_imgs.shape[0]
    epochs = epochs if epochs is not None else cfg.attack_epochs
    num_classes = None
    delta0 = np.asarray(delta0, np.float32)
    M = delta0.reshape(-1, 4).shape[0]
    view_batch = max(cfg.view_batch, 1)
    n_shards = int(mesh.shape.get("data", 1)) if mesh is not None else 1
    if mesh is not None:
        # round up to a multiple of the data axis so every batch shards
        view_batch = ((max(view_batch, n_shards) + n_shards - 1)
                      // n_shards) * n_shards
    writer = mesh is None or mesh.is_writer
    cache = DeviceBudgetCache(PLAN_DEVICE_BUDGET, device=dev)

    @torch.no_grad()
    def eval_views(delta, w, i, ori):
        out = splat_attack_forward(
            delta.reshape(-1, 4), w, i, ori.to(torch.float32), logits_fn,
            eps=cfg.eps, resize_to=resize_to, device=dev,
        )
        preds = torch.stack([torch.argmax(out["logits"], dim=-1),
                             torch.argmax(out["ori_logits"], dim=-1)], 1)
        if mesh is not None:
            preds = mesh.all_gather(preds.to(mesh.comm_device))
        preds = preds.cpu().numpy()
        return out["logits"], out["ori_logits"], preds[:, 0], preds[:, 1]

    def build_batch(s: int):
        ids, _ = _nerfail_batch_ids(s, n, view_batch)
        if mesh is not None:
            ids = local_rows(ids, mesh)
        w_b = _take(weights, ids, dev).to(torch.float32)
        idx_b = _take(idx, ids, dev)
        ori_b = _take(ori_imgs, ids, dev)
        batch = [w_b, idx_b, ori_b]
        if planned:
            batch.append(build_batched_csr_plan(
                idx_b, w_b, M, pair_mask=ori_b[..., 3:] > 0))
        return tuple(batch)

    delta = torch.from_numpy(delta0).to(dev)
    result = AttackResult(delta=delta0.copy())
    best_m1 = None
    df_batch = None       # built lazily once num_classes is known

    # ---- reference control-plane state (attack_NeRFail.py:45-46,410-472) --
    m1_lo, m1_hi = 0.0, cfg.m1
    m1 = cfg.m1
    epoch = 0
    epochs_run = 0
    fp = {"n_views": n, "view_shape": list(ori_imgs.shape[1:]),
          "eps": cfg.eps, "m1_init": cfg.m1, "m2_init": cfg.m2,
          "targeted": cfg.targeted, "epochs": epochs}
    if checkpoint_path:
        state = load_attack_state(checkpoint_path, fingerprint=fp)
        if state is not None:
            arrays, meta = state
            delta = torch.from_numpy(arrays["delta"]).to(dev)
            result.delta = arrays["best_delta"]
            result.best_attack_acc = meta["best_attack_acc"]
            result.history = meta["history"]
            best_m1 = meta["best_m1"]
            m1, m1_lo, m1_hi = meta["m1"], meta["m1_lo"], meta["m1_hi"]
            epoch, epochs_run = meta["epoch"], meta["epochs_run"]
    while epoch < epochs:
        t0 = time.time()
        # m2 and its escalation counters reset every epoch
        # (attack_NeRFail.py:329-332)
        m2 = cfg.m2
        no_attack_after_m2 = attacks_after_m2 = 0
        final_epoch = epoch == epochs - 1
        if final_epoch:
            # the reference's final epoch evaluates (and saves) the BEST
            # tensor over the full set, skipping deepfool
            # (attack_NeRFail.py:338-348,420-432)
            delta = torch.from_numpy(np.asarray(result.delta)).to(dev)
        # the final-epoch body clears tensor_not_changed
        # (attack_NeRFail.py:432)
        tensor_changed = final_epoch
        attacked_correct = 0
        df_calls = df_iters_total = 0
        df_iters = []
        for s in range(0, n, view_batch):
            _, valid = _nerfail_batch_ids(s, n, view_batch)
            batch = cache.get(s, lambda s=s: build_batch(s))
            w, i, ori = batch[:3]
            plan = batch[3] if planned else None
            logits, ori_logits, preds, ori_preds = eval_views(
                delta, w, i, ori)
            same = (preds == ori_preds) & valid
            attacked_correct += int(same.sum())
            if final_epoch or not same.any():
                continue
            if num_classes is None:
                num_classes = int(logits.shape[-1])
            if df_batch is None:
                df_batch = make_batched_deepfool(
                    logits_fn, cfg, resize_to, num_classes, planned=planned,
                    mesh=mesh)
            active = same if mesh is None else local_rows(same, mesh)
            rot_sum, iters_v, used, complete = df_batch(
                delta, w, i, ori, ori_logits,
                torch.from_numpy(active).to(dev), m1, m2, plan,
            )
            iters_v = iters_v.cpu().numpy()
            used = used.cpu().numpy()
            complete = complete.cpu().numpy()
            df_calls += int(same.sum())
            df_iters_total += int(iters_v[same].sum())
            df_iters.append(iters_v.tolist())
            n_used = int(used.sum())
            if n_used:
                delta = delta + rot_sum
                tensor_changed = True
                attacks_after_m2 += n_used
            failed = same & ~complete & ~used
            nf = int(failed.sum())
            if nf and m2 < M2_MAX_LIMIT:
                no_attack_after_m2 += nf
                attacks_after_m2 += nf
                if (attacks_after_m2 > 10
                        and no_attack_after_m2 / attacks_after_m2 > 0.5):
                    m2 *= 10.0
                    no_attack_after_m2 = attacks_after_m2 = 0

        attack_acc = attacked_correct / n
        entry = {
            "epoch": epoch, "m1": m1, "m2": m2,
            "attack_acc": attack_acc,
            "deepfool_calls": df_calls,
            "mean_df_iters": df_iters_total / max(df_calls, 1),
            "deepfool_iters": df_iters,
            "time_s": time.time() - t0,
        }
        result.history.append(entry)
        if log_fn:
            log_fn(epoch, entry)

        # best-tensor tracking (attack_NeRFail.py:490-503)
        if best_m1 is None or (
            attack_acc <= result.best_attack_acc and m1 == best_m1
        ) or (best_m1 is not None and m1 > best_m1 and attack_acc < 1.0):
            result.best_attack_acc = attack_acc
            best_m1 = m1
            result.delta = delta.cpu().numpy()

        # m1 bisection state machine (attack_NeRFail.py:434-472)
        if not tensor_changed:
            if m1_lo < m1 - 1 and epoch == 0:
                m1_hi = m1
                m1 = int((m1 + m1_lo) / 2)
                epoch = 0
            elif m1_lo < m1 and epoch == 0:
                m1_hi = m1
                m1 = m1_lo
                epoch = 0
            else:
                # bisection exhausted: force the final epoch (full-set eval
                # of the best tensor) instead of exiting immediately
                # (attack_NeRFail.py:455 `epoch = attack_epochs - 1`)
                epoch = epochs - 1
        elif epoch == epochs - 1:
            if m1 < m1_hi - 1:
                m1_lo = m1
                m1 = int((m1 + m1_hi) / 2)
                epoch = 0
            elif m1 < m1_hi:
                m1_lo = m1
                m1 = m1_hi
                epoch = 0
            else:
                epoch += 1
        else:
            epoch += 1

        # safety net absent from the reference: when the tensor never
        # changes, the integer bisection can ping-pong between m1_lo and
        # m1_lo+1 forever — cap the total epochs actually executed.
        epochs_run += 1
        if (checkpoint_path and writer
                and epochs_run % checkpoint_every == 0):
            # snapshot AFTER the state machine: m1/epoch are the values the
            # next loop iteration will observe, so resume continues exactly
            save_attack_state(
                checkpoint_path,
                {"delta": delta.cpu().numpy(), "best_delta": result.delta},
                {"best_attack_acc": result.best_attack_acc,
                 "history": result.history, "best_m1": best_m1,
                 "m1": m1, "m1_lo": m1_lo, "m1_hi": m1_hi,
                 "epoch": epoch, "epochs_run": epochs_run},
                fingerprint=fp,
            )
        if epochs_run >= max(10 * epochs, epochs + 20):
            break

    if writer:
        clear_attack_state(checkpoint_path)
    if mesh is not None:
        mesh.barrier()
    return result


def _nerfail_batch_ids(s: int, n: int, view_batch: int):
    """Pad the ragged tail to the batch shape; mask marks real views."""
    ids = np.arange(s, min(s + view_batch, n))
    valid = np.ones(len(ids), bool)
    if len(ids) < view_batch:
        pad = view_batch - len(ids)
        ids = np.concatenate([ids, np.full(pad, ids[-1])])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    return ids, valid
