"""Model zoo (``mxtpu.gluon.model_zoo`` counterpart)."""
from . import vision  # noqa: F401
