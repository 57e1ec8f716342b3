"""Host-side data helpers of the port (numpy)."""

from .file_io import read_img, write_pfm
from .transforms import normalize, to_unit

__all__ = ["normalize", "read_img", "to_unit", "write_pfm"]
