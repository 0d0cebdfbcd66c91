"""Classifier training — the reference model_train.py harness.

Ports nerfail_tpu/train/classifier_trainer.py. Parity points
(model_train.py:100-195):
  - 8-class dataset of per-scene renders, RGBA→white-bg RGB, 0-255 floats
  - SGD lr=1e-3 momentum=0.9, cross-entropy; (logits, aux) outputs get
    the aux loss ×0.4
  - batch 16, 200 epochs; best-val-accuracy and every-50-epochs
    checkpoints
  - each epoch's order is np.random.default_rng(seed).permutation, as in
    the JAX package

The model holds its parameters and buffers (BatchNorm statistics, the
JAX package's `extra`), so the state is (model, optimizer, step). The
model comes initialised by the caller (seed with torch.manual_seed).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfail_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]],
                            torch.optim.Optimizer]


@dataclass
class ClassifierState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_classifier_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    aux_weight: float = 0.4,
) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """One optimizer step on (x [B, S, S, 3], y [B]) in train mode; handles
    (logits, aux) outputs. Returns the batch's loss and accuracy."""

    def step(x: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.train()
        out = model(x)
        if isinstance(out, tuple):
            logits, aux = out
            loss = (F.cross_entropy(logits, y)
                    + aux_weight * F.cross_entropy(aux, y))
        else:
            logits = out
            loss = F.cross_entropy(logits, y)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        acc = torch.mean((torch.argmax(logits.detach(), -1) == y).float())
        return {"loss": loss.detach(), "acc": acc}

    return step


def train_classifier(
    model: nn.Module,
    images: np.ndarray,           # [N, S, S, 3] 0-255 floats (already resized)
    labels: np.ndarray,           # [N] int
    val_images: np.ndarray,
    val_labels: np.ndarray,
    epochs: int = 200,
    batch_size: int = 16,
    lr: float = 1e-3,
    momentum: float = 0.9,
    seed: int = 0,
    logdir: Optional[str] = None,
    log_fn: Optional[Callable] = None,
    aux_weight: float = 0.4,
    optimizer: Optional[OptimizerFactory] = None,
    device: DeviceLike = "cuda",
) -> ClassifierState:
    """Train `model` in place on `device` and return its state.

    `optimizer` is a factory of the parameters that overrides the
    reference-parity SGD(lr, momentum=.9) (model_train.py:148-152), e.g.
    `lambda p: torch.optim.Adam(p, lr=1e-3)` for quickly converging
    fixture classifiers. With `logdir`, `best.ckpt` is written on every new
    best validation accuracy and `epoch_XXXX.ckpt` every 50 epochs."""
    dev = resolve_device(device)
    model.to(dev)
    opt = (optimizer(model.parameters()) if optimizer is not None
           else torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum))
    step_fn = make_classifier_train_step(model, opt, aux_weight)

    n = images.shape[0]
    n_batches = n // batch_size
    images_d = torch.as_tensor(np.asarray(images, np.float32), device=dev)
    labels_d = torch.as_tensor(np.asarray(labels, np.int64), device=dev)
    best_acc, step = -1.0, 0

    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        perm = rng.permutation(n)[: n_batches * batch_size]
        perm = torch.from_numpy(perm.reshape(n_batches, batch_size)).to(dev)
        tr_loss = tr_acc = 0.0
        for b in range(n_batches):
            m = step_fn(images_d[perm[b]], labels_d[perm[b]])
            tr_loss += float(m["loss"])
            tr_acc += float(m["acc"])
            step += 1

        val_acc = evaluate_accuracy(model, val_images, val_labels,
                                    batch_size, device=dev)
        if log_fn:
            log_fn(epoch, {
                "loss": tr_loss / max(n_batches, 1),
                "acc": tr_acc / max(n_batches, 1),
                "val_acc": val_acc,
            })
        if logdir and val_acc > best_acc:
            best_acc = val_acc
            save_checkpoint(os.path.join(logdir, "best.ckpt"),
                            {"model": model.state_dict()})
        if logdir and (epoch + 1) % 50 == 0:
            save_checkpoint(os.path.join(logdir, f"epoch_{epoch+1:04d}.ckpt"),
                            {"model": model.state_dict()})

    return ClassifierState(model, opt, step)


@torch.no_grad()
def evaluate_accuracy(
    model: nn.Module, images: np.ndarray, labels: np.ndarray,
    batch_size: int = 16, device: DeviceLike = "cuda",
) -> float:
    """Top-1 accuracy in eval mode; the model is left in the mode it had."""
    dev = resolve_device(device)
    was_training = model.training
    model.eval()
    correct = 0
    n = images.shape[0]
    for s in range(0, n, batch_size):
        x = torch.as_tensor(np.asarray(images[s:s + batch_size], np.float32),
                            device=dev)
        logits = model(x)
        if isinstance(logits, tuple):
            logits = logits[0]
        pred = torch.argmax(logits, -1).cpu().numpy()
        correct += int(np.sum(pred == np.asarray(labels[s:s + batch_size])))
    model.train(was_training)
    return correct / max(n, 1)


def load_classifier(path: str, model: nn.Module,
                    device: DeviceLike = "cuda") -> nn.Module:
    """Restore a checkpoint written by train_classifier into `model` (on
    `device`); returns the model."""
    dev = resolve_device(device)
    state = load_checkpoint(path, map_location=dev)
    model.load_state_dict(state["model"])
    return model.to(dev)
