"""On the card, at the cells' own sizes: the program's readings pass the
limits and the control's (the float8 reference in the program's place)
and each planted fault's fail one of them. Run there with
`python -m pytest -m gpu -p no:cacheprovider benchmark/tests/test_bench_gpu.py`."""

import pytest
import torch

from benchmark import controls, harness

SEED = 3_000_000_777


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _fails(cell, vals) -> bool:
    limits = cell.workload["limits"]
    return any(vals[k] > float(v) for k, v in limits.items())


@pytest.mark.gpu
@pytest.mark.parametrize("kind,bad", [
    ("program", False), ("control", True), ("half_batch", True),
    ("state_unchanged", True)])
def test_train_limits_separate(card, kind, bad):
    cell = harness.load_cell("nerf_lego_8x256.train")
    ctx = harness.Context(cell, SEED, 1.0, card)
    assert _fails(cell, controls.train_readings(ctx, kind)) == bad


@pytest.mark.gpu
@pytest.mark.parametrize("kind,bad", [
    ("program", False), ("control", True), ("altered", True),
    ("half", True)])
def test_render_limits_separate(card, kind, bad):
    cell = harness.load_cell("nerf_lego_8x256.render")
    ctx = harness.Context(cell, SEED, 1.2, card)
    assert _fails(cell, controls.render_readings(ctx, kind)) == bad


@pytest.mark.gpu
def test_nerfail_s_limits_separate(card):
    cell = harness.load_cell("inception_v3_800.nerfail_s_400v")
    ctx = harness.Context(cell, SEED, 0.0, card)
    got = controls.nerfail_s_readings(ctx, with_control=True)
    assert not _fails(cell, got["program"])
    assert _fails(cell, got["control"])
