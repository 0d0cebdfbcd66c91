"""PyTorch port, slice 3: the NeRF ops against the JAX package and the
reference goldens.

Inputs are made from seeded numpy draws and given to both packages.
Tolerances: the encoding, rays and stratified depths at rtol 1e-6 (the
same f32 formulas; sin/cos and the three-term ray rotation may differ in
the last bit); sample_pdf and raw2outputs at rtol 1e-5, atol 1e-6 (f32
cumsum / cumprod in another order); the reference goldens at the JAX
package's own tolerances (tests/test_parity.py).
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "reference_goldens.npz")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("L,include", [(10, True), (4, True), (3, False),
                                       (0, True)])
def test_positional_encoding(L, include):
    from nerfail_tpu.ops.encoding import encoder_output_dim as jdim
    from nerfail_tpu.ops.encoding import positional_encoding as jpe
    from nerfail_tpu_torch.ops.encoding import encoder_output_dim as tdim
    from nerfail_tpu_torch.ops.encoding import positional_encoding as tpe

    x = np.random.default_rng(L).uniform(-3, 3, (7, 5, 3)).astype(np.float32)
    got = tpe(_t(x), L, include_input=include).numpy()
    want = np.asarray(jpe(jnp.asarray(x), L, include_input=include))
    assert got.shape == want.shape
    assert tdim(3, L, include) == jdim(3, L, include) == got.shape[-1]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_get_rays_and_ndc():
    from nerfail_tpu.ops.rays import get_rays as jrays
    from nerfail_tpu.ops.rays import ndc_rays as jndc
    from nerfail_tpu_torch.data.poses import pose_spherical
    from nerfail_tpu_torch.ops.rays import get_rays, ndc_rays

    H, W, focal = 12, 16, 20.0
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    c2w = pose_spherical(37.0, -25.0, 3.5).astype(np.float32)
    o, d = get_rays(H, W, _t(K), _t(c2w))
    jo, jd = jrays(H, W, jnp.asarray(K), jnp.asarray(c2w))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
    # forward-facing rays (every ray points down -z, as LLFF's do)
    rng = np.random.default_rng(1)
    ro = rng.uniform(-0.3, 0.3, (50, 3)).astype(np.float32)
    rd = np.concatenate([rng.uniform(-0.4, 0.4, (50, 2)),
                         -rng.uniform(0.8, 1.2, (50, 1))], -1).astype(np.float32)
    no, nd = ndc_rays(H, W, focal, 1.0, _t(ro), _t(rd))
    jno, jnd = jndc(H, W, focal, 1.0, jnp.asarray(ro), jnp.asarray(rd))
    np.testing.assert_allclose(no.numpy(), np.asarray(jno), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(nd.numpy(), np.asarray(jnd), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_z_vals(lindisp):
    from nerfail_tpu.ops.sampling import stratified_z_vals as jz
    from nerfail_tpu_torch.ops.sampling import stratified_z_vals as tz

    t_rand = np.random.default_rng(2).uniform(size=(6, 9)).astype(np.float32)
    for tr in (None, t_rand):
        got = tz(6, 9, 2.0, 6.0, lindisp,
                 t_rand=None if tr is None else _t(tr)).numpy()
        want = np.asarray(jz(6, 9, 2.0, 6.0, lindisp,
                             t_rand=None if tr is None else jnp.asarray(tr)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _pdf_inputs(seed, n=8, m=20):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2, 6, (n, m + 1)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (n, m)).astype(np.float32)
    w[0] = 0.0                                   # an empty ray: uniform pdf
    w[1, 5:] = 0.0
    return bins, w


@pytest.mark.parametrize("mode", ["det", "u"])
def test_sample_pdf_matches_jax(mode):
    from nerfail_tpu.ops.sampling import sample_pdf as jpdf
    from nerfail_tpu_torch.ops.sampling import sample_pdf as tpdf

    bins, w = _pdf_inputs(3)
    u = None
    if mode == "u":
        u = np.random.default_rng(4).uniform(size=(8, 33)).astype(np.float32)
    got = tpdf(_t(bins), _t(w), 33, det=mode == "det",
               u=None if u is None else _t(u)).numpy()
    want = np.asarray(jpdf(jnp.asarray(bins), jnp.asarray(w), 33,
                           det=mode == "det",
                           u=None if u is None else jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sample_pdf_searchsorted_on_exact_cdf_values():
    """u lying exactly on cdf entries, on 0, on 1 and one ulp past an
    entry: searchsorted(right) with below = idx-1, above = min(idx, M)
    picks the neighbours that the JAX package's masked reductions pick.
    The two packages' f32 cumsums may differ in the last bit, so each is
    probed at its own cdf entries; on an entry the sample is the bin edge."""
    from nerfail_tpu.ops.sampling import sample_pdf as jpdf
    from nerfail_tpu_torch.ops.sampling import sample_pdf as tpdf

    bins, w = _pdf_inputs(5, n=4, m=10)

    def probes(cdf):
        cdf = np.asarray(cdf, np.float32)
        return np.concatenate([cdf, np.full((4, 1), 1.0, np.float32),
                               np.nextafter(cdf[:, 3:4], np.float32(2))], -1)

    tw = _t(w) + 1e-5
    tcdf = torch.cat([torch.zeros(4, 1),
                      torch.cumsum(tw / tw.sum(-1, keepdim=True), -1)], -1)
    jw = jnp.asarray(w) + 1e-5
    jcdf = jnp.concatenate([jnp.zeros((4, 1)), jnp.cumsum(
        jw / jnp.sum(jw, -1, keepdims=True), -1)], -1)
    tu, ju = probes(tcdf.numpy()), probes(jcdf)
    got = tpdf(_t(bins), _t(w), tu.shape[1], u=_t(tu)).numpy()
    want = np.asarray(jpdf(jnp.asarray(bins), jnp.asarray(w), ju.shape[1],
                           u=jnp.asarray(ju)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[:, :10], bins[:, :10])


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("noisy", [False, True])
def test_raw2outputs_matches_jax(white, noisy):
    from nerfail_tpu.ops.volume import raw2outputs as jr2o
    from nerfail_tpu_torch.ops.volume import raw2outputs as tr2o

    rng = np.random.default_rng(6)
    raw = rng.normal(0, 2, (9, 12, 4)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (9, 12)), -1).astype(np.float32)
    d = rng.normal(0, 1, (9, 3)).astype(np.float32)
    noise = rng.normal(0, 1, (9, 12)).astype(np.float32) if noisy else None
    got = tr2o(_t(raw), _t(z), _t(d), white_bkgd=white,
               noise=None if noise is None else _t(noise))
    want = jr2o(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d),
                white_bkgd=white,
                noise=None if noise is None else jnp.asarray(noise))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_sample_pdf_goldens(g):
    from nerfail_tpu_torch.ops.sampling import sample_pdf

    np.random.seed(0)                          # the reference's pytest hook
    u = np.random.rand(4, 6).astype(np.float32)
    ours = sample_pdf(_t(g["sample_pdf/bins"]), _t(g["sample_pdf/weights"]),
                      6, u=_t(u))
    np.testing.assert_allclose(ours.numpy(), g["sample_pdf/samples"],
                               rtol=1e-5, atol=1e-5)
    ours = sample_pdf(_t(g["sample_pdf/bins"]), _t(g["sample_pdf/weights"]),
                      6, det=True)
    np.testing.assert_allclose(ours.numpy(), g["sample_pdf/samples_det"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tag,white", [("black", False), ("white", True)])
def test_raw2outputs_goldens(g, tag, white):
    from nerfail_tpu_torch.ops.volume import raw2outputs

    out = raw2outputs(_t(g["raw2outputs/raw"]), _t(g["raw2outputs/z_vals"]),
                      _t(g["raw2outputs/rays_d"]), white_bkgd=white)
    for k, ref_k in (("rgb_map", "rgb"), ("disp_map", "disp"),
                     ("acc_map", "acc"), ("weights", "weights"),
                     ("depth_map", "depth")):
        np.testing.assert_allclose(out[k].numpy(),
                                   g[f"raw2outputs/{tag}/{ref_k}"],
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_exclusive_cumprod_and_chunking():
    from nerfail_tpu.utils.chunk import pad_to_multiple as jpad
    from nerfail_tpu_torch.ops.volume import exclusive_cumprod
    from nerfail_tpu_torch.utils.chunk import chunked_map, pad_to_multiple

    x = torch.tensor([[0.5, 0.25, 2.0], [1.0, 3.0, 0.5]])
    torch.testing.assert_close(exclusive_cumprod(x),
                               torch.tensor([[1.0, 0.5, 0.125],
                                             [1.0, 1.0, 3.0]]))
    a = np.arange(10, dtype=np.float32).reshape(5, 2)
    got, n = pad_to_multiple(_t(a), 4)
    want, jn = jpad(jnp.asarray(a), 4)
    assert n == jn == 5
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xs = {"a": torch.arange(11.0), "b": torch.arange(22.0).view(11, 2)}
    out = chunked_map(lambda t: {"s": t["a"] + t["b"].sum(-1)}, xs, 4)
    torch.testing.assert_close(out["s"], xs["a"] + xs["b"].sum(-1))
