"""Feature scenes (lights) on the XLA integrators: brute force vs BVH,
tiled vs whole frame, sharded vs single device (tests/feature_scenes.py)."""
import pytest

from .feature_scenes import check


@pytest.mark.parametrize("invariant", ["accel", "tiles", "sharded"])
@pytest.mark.parametrize("name", ["pixel_filter", "rotated_emitter_sphere", "many_lights_64"])
def test_feature_scene(name, invariant, scene_dir, monkeypatch):
    check(name, invariant, scene_dir, monkeypatch)
