"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""
import jax
import numpy as np
import pytest

from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene

SRC = """
LookAt 3 4 1.5 0 0 0 0 0 1
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [32] "integer yresolution" [24]
WorldBegin
LightSource "infinite" "rgb L" [.4 .45 .5]
AttributeBegin
  Material "matte" "rgb Kd" [ .7 .2 .2 ]
  Shape "sphere" "float radius" 1
AttributeEnd
WorldEnd
"""


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


def test_mesh_render_matches_mean(eight_devices):
    from rene_tpu.parallel.shard import make_mesh, render_multichip
    scene = create_scene(parse_pbrt(SRC), "/tmp")
    mesh = make_mesh(eight_devices)
    out = render_multichip(scene, spp=8, seed=0, mesh=mesh)
    assert out["effective_spp"] == 8
    img = out["color"]
    assert img.shape == (24, 32, 3)
    # background pixels equal the infinite light color
    np.testing.assert_allclose(img[0, 0], [0.4, 0.45, 0.5], atol=0.02)
    # sphere center is the matte red under uniform sky
    assert img[12, 16, 0] > img[12, 16, 1]


def test_sharded_sample_is_deterministic(eight_devices):
    import jax.numpy as jnp

    from rene_tpu.parallel.shard import make_mesh, render_sample_sharded
    from rene_tpu.scene.device import build_device_scene, to_jax
    scene = create_scene(parse_pbrt(SRC), "/tmp")
    buffers_np, config = build_device_scene(scene)
    buffers = to_jax(buffers_np)
    mesh = make_mesh(eight_devices)
    run = render_sample_sharded(mesh, config)
    px = jnp.arange(64, dtype=jnp.int32) % 32
    py = jnp.arange(64, dtype=jnp.int32) % 24
    a = run(buffers, px, py, jnp.uint32(42))
    b = run(buffers, px, py, jnp.uint32(42))
    np.testing.assert_array_equal(np.asarray(a["radiance"]),
                                  np.asarray(b["radiance"]))
    assert float(a["rays"]) > 0


def test_tile_sharded_render_matches_samples(eight_devices):
    """Film-tile parallelism: each chip traces a pixel shard of the same
    sample; the image statistically matches the sample-DP mode."""
    from rene_tpu.parallel.shard import make_mesh, render_multichip
    scene = create_scene(parse_pbrt(SRC), "/tmp")
    mesh = make_mesh(eight_devices)
    tiles = render_multichip(scene, spp=8, seed=0, mesh=mesh, mode="tiles")
    assert tiles["effective_spp"] == 8
    img = tiles["color"]
    assert img.shape == (24, 32, 3)
    # deterministic pixels are exact
    np.testing.assert_allclose(img[0, 0], [0.4, 0.45, 0.5], atol=0.02)
    # statistical agreement with sample-DP on the same scene
    samples = render_multichip(scene, spp=8, seed=1, mesh=mesh,
                               mode="samples")
    assert np.abs(img.mean(axis=(0, 1))
                  - samples["color"].mean(axis=(0, 1))).max() < 0.02


def test_tile_sharded_pads_ragged_batches(eight_devices):
    """A film whose pixel count doesn't divide the mesh still renders."""
    from rene_tpu.parallel.shard import make_mesh, render_multichip
    src = SRC.replace('[32]', '[31]').replace('[24]', '[21]')
    scene = create_scene(parse_pbrt(src), "/tmp")
    mesh = make_mesh(eight_devices)
    out = render_multichip(scene, spp=2, seed=3, mesh=mesh, mode="tiles")
    assert out["color"].shape == (21, 31, 3)
    assert np.isfinite(out["color"]).all()
