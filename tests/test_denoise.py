

def test_cnn_denoiser_odd_resolution():
    """The U-Net must handle films whose dimensions are not divisible
    by 2^levels (avg_pool floors odd sizes; the decoder edge-pads
    back). 320x180 crashed before the fix: 180 -> 90 -> 45 -> 22
    upsamples to 44 != 45."""
    import numpy as np

    from rene_tpu.models.denoise import denoise

    rng = np.random.RandomState(0)
    h, w = 45, 52
    color = rng.rand(h, w, 3).astype(np.float32)
    normal = rng.rand(h, w, 3).astype(np.float32)
    albedo = rng.rand(h, w, 3).astype(np.float32)
    out = denoise(color, normal, albedo, method="cnn")
    assert out.shape == (h, w, 3)
    assert np.isfinite(out).all()


def _nine_shift_conv(x, k):
    """The U-Net's former convolution: nine shifted einsums (SAME, NHWC
    input, HWIO kernel) — the reference the conv is held to."""
    import jax
    import jax.numpy as jnp
    h, w = x.shape[1], x.shape[2]
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = 0.0
    for dy in range(3):
        for dx in range(3):
            out = out + jnp.einsum("bhwc,co->bhwo",
                                   xp[:, dy:dy + h, dx:dx + w, :], k[dy, dx],
                                   precision=jax.lax.Precision.HIGHEST)
    return out


import pytest  # noqa: E402


@pytest.mark.parametrize("shape", [(1, 9, 13, 12, 24), (2, 16, 16, 24, 3),
                                   (1, 45, 22, 48, 48), (1, 1, 1, 3, 5)])
def test_conv3x3_equals_nine_shifted_einsums(shape):
    import numpy as np

    from rene_tpu.models.denoise import conv3x3

    b, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    ref = np.asarray(_nine_shift_conv(x, k))
    # float32 sums of 9*cin products taken in another order
    np.testing.assert_allclose(np.asarray(conv3x3(x, k)), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_shipped_weights_load_and_keep_their_shapes():
    """unet.msgpack (12 input channels) loads into the conv_general_dilated
    U-Net unchanged and denoises; every kernel is HWIO 3x3."""
    import os

    import jax
    import numpy as np

    from rene_tpu.models.denoise import UNetDenoiser

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "rene_tpu", "models", "weights",
        "unet.msgpack")
    net = UNetDenoiser.load(path)
    kernels = [v for p, v in jax.tree_util.tree_leaves_with_path(net.params)
               if p[-1].key == "kernel"]
    assert kernels and all(k.shape[:2] == (3, 3) for k in kernels)
    rng = np.random.default_rng(1)
    c, n, a = (rng.random((12, 20, 3)).astype(np.float32) for _ in range(3))
    out = net(c, n, a)
    assert out.shape == (12, 20, 3) and np.isfinite(out).all()


def test_missing_flax_names_the_package(monkeypatch):
    import sys

    from rene_tpu.models.denoise import UNetDenoiser

    monkeypatch.setitem(sys.modules, "flax", None)
    monkeypatch.setitem(sys.modules, "flax.linen", None)
    with pytest.raises(ImportError, match="flax"):
        UNetDenoiser()


def test_missing_pillow_names_the_package(monkeypatch, tmp_path):
    import sys

    from rene_tpu.scene.assets.images import load_image

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        load_image(str(tmp_path / "tex.png"))
