from .image import save_png  # noqa: F401
from .checkpoint import save_checkpoint, load_checkpoint  # noqa: F401
