"""IO: images (PNG out, images in, the HDR tonemap), scene configs and
training checkpoints."""

from .image import write_png, read_image, tonemap
from .config import SceneConfig, load_config, build_scene
from .checkpoint import save_train_state, load_train_state

__all__ = [
    "write_png", "read_image", "tonemap",
    "SceneConfig", "load_config", "build_scene",
    "save_train_state", "load_train_state",
]
