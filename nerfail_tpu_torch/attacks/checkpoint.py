"""Mid-attack checkpoint/resume for the 100-epoch attack engines.

The reference saves only FINAL attack artifacts (perturbation PNGs at
attack_NeRFail.py:508-512, the UAP tensor at attack_UAP_2D.py:363) — a
crash at epoch 97 of a 100-epoch × 300-view DeepFool run loses everything.
On preemptible machines resumable attack state is a first-class obligation
(SURVEY.md §5 checkpoint bullet), the analogue of the reference's NeRF
auto-resume (run_nerf.py:216-233).

State is one atomically-replaced .npz: the perturbation arrays plus a JSON
blob carrying the host-side control-plane scalars (epoch counters, m1
bisection bounds, m2, best attack acc) and the epoch history.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

_META_KEY = "__meta_json__"


def save_attack_state(
    path: str, arrays: Dict[str, np.ndarray], meta: Dict[str, Any],
    fingerprint: Optional[Dict[str, Any]] = None,
) -> str:
    """Atomically persist attack state: named arrays + JSON-able meta.

    `fingerprint` identifies the run configuration (view count/shape,
    ε, targets, …); `load_attack_state` discards a checkpoint whose
    fingerprint doesn't match instead of silently resuming mismatched
    state from a crashed run that happened to share the path (ADVICE r2).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    payload = dict(meta)
    if fingerprint is not None:
        payload["__fingerprint__"] = fingerprint
    with open(tmp, "wb") as f:
        np.savez(
            f,
            **{_META_KEY: np.frombuffer(
                json.dumps(payload).encode(), dtype=np.uint8
            )},
            **{k: np.asarray(v) for k, v in arrays.items()},
        )
    os.replace(tmp, path)
    return path


def load_attack_state(
    path: str,
    fingerprint: Optional[Dict[str, Any]] = None,
) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, Any]]]:
    """Load attack state saved by `save_attack_state`; None if absent or
    if `fingerprint` is given and doesn't match the saved one."""
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        meta = json.loads(bytes(data[_META_KEY].tobytes()).decode())
        arrays = {k: data[k] for k in data.files if k != _META_KEY}
    saved_fp = meta.pop("__fingerprint__", None)
    if fingerprint is not None and saved_fp is not None \
            and saved_fp != fingerprint:
        import warnings

        warnings.warn(
            f"attack checkpoint {path} was written by a different run "
            f"configuration ({saved_fp} != {fingerprint}); ignoring it",
            stacklevel=2,
        )
        return None
    return arrays, meta


def clear_attack_state(path: Optional[str]) -> None:
    """Remove a finished run's in-flight state (final artifacts supersede
    it; a stale checkpoint would make the next run resume a done attack)."""
    if path and os.path.exists(path):
        os.remove(path)
