"""IO: PNG out, images in, the HDR tonemap, and training checkpoints."""

from .checkpoint import load_train_state, save_train_state
from .image import read_image, tonemap, write_png

__all__ = ["load_train_state", "read_image", "save_train_state", "tonemap",
           "write_png"]
