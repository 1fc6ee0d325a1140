"""Feature scenes (textures) on the XLA integrators: brute force vs BVH,
tiled vs whole frame, sharded vs single device (tests/feature_scenes.py)."""
import pytest

from .feature_scenes import check


@pytest.mark.parametrize("invariant", ["accel", "tiles", "sharded"])
@pytest.mark.parametrize("name", ["imagemap_kd", "substrate_plastic_kdmap", "textured_roughness_ks"])
def test_feature_scene(name, invariant, scene_dir, monkeypatch):
    check(name, invariant, scene_dir, monkeypatch)
