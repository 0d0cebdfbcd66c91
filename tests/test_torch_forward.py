"""PyTorch port: resize matrices and the attack forward against JAX.

The resize matrices are jax.image.resize's antialiased bilinear weights
(ROADMAP Queue 3 "Resize"); both sides compute them in f32, so they agree
to 1e-6. The forward is compared at 32² with a linear classifier given
the same weights on both sides: rtol 1e-5 on 0-255 values (f32 sums of
8 neighbours and of the resize products in another order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n_in,n_out", [(800, 299), (64, 32), (32, 48),
                                        (299, 299)])
def test_resize_matrices_equal_jax(n_in, n_out):
    from nerfail_tpu.attacks.forward import _resize_weights as jw
    from nerfail_tpu_torch.attacks.forward import _resize_weights as tw

    got, want = tw(n_in, n_out), jw(n_in, n_out)
    assert got.shape == want.shape == (n_out, n_in)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_resize_batch_matches_jax():
    from nerfail_tpu.attacks.forward import resize_batch as jr
    from nerfail_tpu_torch.attacks.forward import resize_batch as tr

    x = np.random.default_rng(0).uniform(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    np.testing.assert_allclose(tr(torch.from_numpy(x), 32).numpy(),
                               np.asarray(jr(jnp.asarray(x), 32)),
                               rtol=1e-5, atol=1e-3)


def test_splat_attack_forward_matches_jax_at_32():
    from nerfail_tpu.attacks.forward import splat_attack_forward as jf
    from nerfail_tpu.attacks.forward import zero_init_mask as jz
    from nerfail_tpu_torch.attacks.forward import splat_attack_forward as tf
    from nerfail_tpu_torch.attacks.forward import zero_init_mask as tz

    rng = np.random.default_rng(1)
    B, H, M = 2, 32, 2 * 32 * 32
    mask_imgs = rng.uniform(0, 255, (2, H, H, 4)).astype(np.float32)
    mask_imgs[..., 3] *= rng.uniform(size=(2, H, H)) > 0.3
    delta0 = tz(torch.from_numpy(mask_imgs)).numpy()
    np.testing.assert_array_equal(delta0, np.asarray(jz(jnp.asarray(
        mask_imgs))))
    pts = delta0.reshape(-1, 4).copy()
    pts[:, :3] = rng.uniform(-40, 40, (M, 3))
    w = rng.uniform(0, 0.2, (B, H, H, 8)).astype(np.float32)
    idx = rng.integers(0, M, (B, H, H, 8)).astype(np.int32)
    ori = rng.uniform(0, 255, (B, H, H, 4)).astype(np.float32)
    ori[..., 3] *= rng.uniform(size=(B, H, H)) > 0.4
    Wc = rng.standard_normal((3, 8)).astype(np.float32) * 0.01

    def jlogits(x):
        return jnp.mean(x, axis=(1, 2)) @ jnp.asarray(Wc)

    def tlogits(x):
        return torch.mean(x, dim=(1, 2)) @ torch.from_numpy(Wc)

    for resize_to in (None, 16):
        j = jf(jnp.asarray(pts), jnp.asarray(w), jnp.asarray(idx),
               jnp.asarray(ori), jlogits, eps=32.0, resize_to=resize_to)
        t = tf(pts, w, idx, ori, tlogits, eps=32.0, resize_to=resize_to,
               device="cpu")
        for key in ("splat", "attacked_rgba", "logits", "ori_logits",
                    "eps_min", "eps_max"):
            np.testing.assert_allclose(t[key].detach().numpy(),
                                       np.asarray(j[key]), rtol=1e-5,
                                       atol=1e-4, err_msg=key)
