"""Feature scenes (backgrounds) on the XLA integrators: brute force vs BVH,
tiled vs whole frame, sharded vs single device (tests/feature_scenes.py)."""
import pytest

from .feature_scenes import check


@pytest.mark.parametrize("invariant", ["accel", "tiles", "sharded"])
@pytest.mark.parametrize("name", ["env_map_bg", "checker_bg", "solid_bg"])
def test_feature_scene(name, invariant, scene_dir, monkeypatch):
    check(name, invariant, scene_dir, monkeypatch)
