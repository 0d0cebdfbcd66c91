"""PyTorch port: ViT-B/16, Mixer-B/16 and Swin-B against the JAX modules.

Each family at 64² with its wiring kept and its depth and width cut, as
the executed-torch twin tests cut them (ViT 3 layers of width 96 with 4
heads; Mixer 4 blocks of width 96; Swin width 32, depths (2, 2, 2),
window 4, so that the 16² and 8² stages are shifted and masked and the
4² stage is one unshifted window). The variables are the seeded random
trees of tests/test_torch_zoo_cnn.py (`cls`, the position embedding and
the relative-position bias tables included) carried across by
convert.load_flax_variables. Tolerance: 1e-5 of the largest logit (fp32
matrix products and exact-erf GELU summed in other orders).
"""

import pytest
import torch

pytest.importorskip("jax")

from tests.test_torch_zoo_cnn import assert_logits_match  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _families():
    from nerfail_tpu.models.classifiers import swin as js, vit as jv
    from nerfail_tpu_torch.models.classifiers import swin as ts, vit as tv

    vit = dict(depth=3, width=96, num_heads=4, mlp_dim=192)
    mixer = dict(depth=4, width=96, tokens_mlp_dim=48, channels_mlp_dim=192)
    swin = dict(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 8),
                window=4)
    return {
        "vit_b_16": (jv.ViT(**vit), tv.ViT(image_size=64, **vit)),
        "mixer_b": (jv.MlpMixer(**mixer),
                    tv.MlpMixer(image_size=64, **mixer)),
        "swin_b": (js.SwinB(**swin), ts.SwinB(image_size=64, **swin)),
    }


@pytest.mark.parametrize("name", ["vit_b_16", "mixer_b", "swin_b"])
def test_transformer_logits_match_jax(name):
    jm, tm = _families()[name]
    assert_logits_match(jm, tm, 64, seed=len(name), tol=1e-5)


def test_swin_stages_shift_and_mask_as_the_jax_module():
    """At 224² the stages are 56², 28², 14² and 7²: window 7, every odd
    block shifted by 3 with its mask except in the last stage, whose one
    window covers it; the masks hold -100 across shift regions."""
    from nerfail_tpu_torch.models.classifiers.swin import SwinB, SwinBlock

    blocks = [m for m in SwinB().modules() if isinstance(m, SwinBlock)]
    assert len(blocks) == 24
    shifts = [b.shift for b in blocks]
    assert shifts == [0, 3] * 11 + [0, 0]
    assert all(b.ws == 7 for b in blocks)
    for b in blocks:
        assert (b.mask is None) == (b.shift == 0)
        if b.mask is not None:
            assert set(b.mask.unique().tolist()) == {-100.0, 0.0}
            assert b.mask.shape[1:] == (49, 49)
