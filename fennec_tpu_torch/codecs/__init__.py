"""Codecs: baseline JPEG (device transforms in torch) and PNG (host)."""

from .. import device as _device
from .jpeg import decode_jpeg
from .png import decode_png


def sniff_format(data: bytes):
    """Return 'jpeg', 'png', or None from magic bytes."""
    if data[:2] == b"\xFF\xD8":
        return "jpeg"
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    return None


def decode_image(data: bytes, device: _device.DeviceLike = None):
    """Decode JPEG or PNG bytes to (H, W, 4) uint8 NRGBA (JPEG transforms
    on `device`; PNG decodes on the host)."""
    fmt = sniff_format(data)
    if fmt == "jpeg":
        return decode_jpeg(data, device)
    if fmt == "png":
        return decode_png(data)
    from ..types import UnsupportedFormatError
    raise UnsupportedFormatError("fennec: unrecognized image data")
