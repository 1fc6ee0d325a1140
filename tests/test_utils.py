"""Utility tests: V3 algebra, SSIM, film encoding, CLI parser."""
import jax.numpy as jnp
import numpy as np
import pytest

from rene_tpu.ops import vec3 as v3
from rene_tpu.ops.vec3 import V3
from rene_tpu.utils.film import (rays_to_image, save_png, to_aov8,
                                 to_aov_normal8, to_rgb8)
from rene_tpu.utils.ssim import ssim


def rand_v3(n, seed):
    r = np.random.default_rng(seed)
    return V3.from_array(jnp.asarray(r.normal(size=(n, 3)).astype(
        np.float32)))


def test_v3_algebra():
    a = rand_v3(64, 0)
    b = rand_v3(64, 1)
    aa = np.asarray(a.to_array(), np.float64)
    bb = np.asarray(b.to_array(), np.float64)
    np.testing.assert_allclose(np.asarray((a + b).to_array()), aa + bb,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(a.dot(b)),
                               np.sum(aa * bb, -1), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(a.cross(b).to_array()),
                               np.cross(aa, bb), rtol=2e-4, atol=1e-6)
    n = a.normalized()
    np.testing.assert_allclose(np.asarray(n.length()), 1.0, rtol=1e-5)


def test_v3_onb_orthonormal():
    w = rand_v3(128, 2).normalized()
    onb = v3.Onb.from_w(w)
    for pair in ((onb.u, onb.v), (onb.u, onb.w), (onb.v, onb.w)):
        assert float(jnp.abs(pair[0].dot(pair[1])).max()) < 1e-5
    # roundtrip
    x = rand_v3(128, 3)
    back = onb.to_world(onb.to_local(x))
    np.testing.assert_allclose(np.asarray(back.to_array()),
                               np.asarray(x.to_array()), rtol=1e-4,
                               atol=1e-5)


def test_v3_reflect():
    n = V3.of([0.0], [0.0], [1.0])
    wo = V3.of([0.6], [0.0], [0.8])
    r = v3.reflect(wo, n)
    np.testing.assert_allclose(np.asarray(r.to_array())[0],
                               [-0.6, 0, 0.8], atol=1e-6)


def test_ssim_identity_and_noise():
    r = np.random.default_rng(0)
    img = r.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    assert ssim(img, img) == pytest.approx(1.0, abs=1e-6)
    noisy = np.clip(img + r.normal(0, 0.2, img.shape), 0, 1)
    s = ssim(img, noisy.astype(np.float32))
    assert 0.0 < s < 0.9


def test_film_encodings():
    lin = np.array([[[0.0, 0.5, 1.0]]], np.float32)
    rgb = to_rgb8(lin)
    assert rgb[0, 0, 0] == 0 and rgb[0, 0, 2] == 255
    assert 180 < rgb[0, 0, 1] < 195  # gamma(0.5) ~ 0.735
    nrm = to_aov_normal8(np.array([[[-1.0, 0.0, 1.0]]], np.float32))
    assert nrm[0, 0, 0] == 0 and nrm[0, 0, 1] == 128
    aov = to_aov8(np.array([[[2.0, 0.5, -1.0]]], np.float32))
    assert aov[0, 0, 0] == 255 and aov[0, 0, 2] == 0


def test_rays_to_image_flip():
    rays = np.arange(12, dtype=np.float32).reshape(6, 2)  # 3x2 film, 2ch
    img = rays_to_image(rays, 2, 3)
    # lane 0 (pixel y=0) lands on the BOTTOM row (reference add_image flip)
    np.testing.assert_array_equal(img[2, 0], rays[0])
    np.testing.assert_array_equal(img[0, 0], rays[4])


def test_save_png_exr_fallback(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    out = save_png(str(tmp_path / "a.exr"), img)
    assert out.endswith(".exr.png")


def test_cli_parser():
    from rene_tpu.cli import build_parser
    p = build_parser()
    args = p.parse_args(["scene.pbrt", "--spp", "16", "--denoiser",
                         "atrous", "--color-space", "srgb-lights"])
    assert args.spp == 16 and not hasattr(args, "engine")
    assert args.color_space == "srgb-lights"
    assert args.denoiser == "atrous"


def _decode_png(data):
    """Minimal PNG reader (8-bit RGB, filter 0 rows) built on zlib."""
    import struct
    import zlib

    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks.append((tag, body))
        pos += 12 + n
    assert [t for t, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, ctype, comp, filt, lace = struct.unpack(">IIBBBBB",
                                                         chunks[0][1])
    assert (depth, ctype, comp, filt, lace) == (8, 2, 0, 0, 0)
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (33, 64)])
def test_png_writer_roundtrip(tmp_path, shape):
    from rene_tpu.utils.film import encode_png
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(_decode_png(encode_png(img)), img)
    out = save_png(str(tmp_path / "a.png"), img)
    with open(out, "rb") as f:
        np.testing.assert_array_equal(_decode_png(f.read()), img)


def test_png_writer_rejects_non_rgb():
    from rene_tpu.utils.film import encode_png
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.uint8))


def test_cli_has_no_engine_flag():
    from rene_tpu.cli import build_parser
    with pytest.raises(SystemExit):
        build_parser().parse_args(["scene.pbrt", "--engine", "pallas"])


def test_sobol_sampler_warns_once(caplog):
    from rene_tpu.pbrt import parse_pbrt
    from rene_tpu.scene import build_device_scene, create_scene
    scene = create_scene(parse_pbrt("""
Sampler "sobol" "integer pixelsamples" [ 16 ]
Film "image" "integer xresolution" [ 4 ] "integer yresolution" [ 4 ]
WorldBegin
LightSource "infinite" "rgb L" [ 1 1 1 ]
WorldEnd"""), ".")
    with caplog.at_level("WARNING", logger="rene_tpu.scene"):
        _, config = build_device_scene(scene)
    assert config.sampler == "sobol"
    assert sum("sobol" in r.getMessage() for r in caplog.records) == 1
