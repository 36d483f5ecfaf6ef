"""On-read image resizing (ref: weed/images/resizing.go:18): fit, fill
and thumbnail modes, parsed from a read's ?width, ?height and ?mode.

Decode, resample and encode are host-side (PIL), as the JAX package does
for single-image HTTP reads. Ported from the JAX package's
images/__init__.py: `should_resize` and `resized`, with PIL guarded as
there. Not ported yet: its batched device resize (`resize_batch`, the
jit program B9) and the client-side upload preprocessing (EXIF
orientation).
"""

from __future__ import annotations

import io
from typing import Tuple

try:
    from PIL import Image, ImageOps

    _HAVE_PIL = True
except Exception:  # pragma: no cover - PIL is in the image
    _HAVE_PIL = False

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".gif")

_PIL_FORMAT = {".png": "PNG", ".jpg": "JPEG", ".jpeg": "JPEG", ".gif": "GIF"}


def resized(
    ext: str, data: bytes, width: int, height: int, mode: str = ""
) -> Tuple[bytes, int, int]:
    """Resize image bytes; returns (bytes, w, h).

    Semantics mirror the reference (ref: weed/images/resizing.go:18-56):
      - width==height==0 → unchanged.
      - only downscales: if the source already fits the requested box the
        original bytes are returned with the source dimensions.
      - mode "fit":   scale to fit inside width×height, keeping aspect.
      - mode "fill":  scale + center-crop to exactly width×height.
      - default:      square thumbnail when width==height and the source
                      is not square; otherwise plain resize where a zero
                      dimension preserves aspect ratio.
    On decode failure the original bytes are returned with (0, 0).
    """
    if (width == 0 and height == 0) or not _HAVE_PIL:
        return data, 0, 0
    try:
        img = Image.open(io.BytesIO(data))
        img.load()
    except Exception:
        return data, 0, 0

    src_w, src_h = img.size
    needs = (src_w > width and width != 0) or (src_h > height and height != 0)
    if not needs:
        return data, src_w, src_h

    if mode == "fit":
        out = ImageOps.contain(img, (width or src_w, height or src_h), Image.LANCZOS)
    elif mode == "fill":
        out = ImageOps.fit(img, (width or src_w, height or src_h), Image.LANCZOS)
    else:
        if width == height and src_w != src_h:
            out = ImageOps.fit(img, (width, height), Image.LANCZOS)
        else:
            w, h = width, height
            if w == 0:
                w = max(1, round(src_w * h / src_h))
            if h == 0:
                h = max(1, round(src_h * w / src_w))
            out = img.resize((w, h), Image.LANCZOS)

    fmt = _PIL_FORMAT.get(ext.lower(), img.format or "PNG")
    buf = io.BytesIO()
    if fmt == "JPEG" and out.mode not in ("RGB", "L"):
        out = out.convert("RGB")
    out.save(buf, format=fmt)
    return buf.getvalue(), out.size[0], out.size[1]


def should_resize(ext: str, query) -> Tuple[int, int, str, bool]:
    """Parse ?width/&height/&mode for image extensions
    (ref: weed/server/volume_server_handlers_read.go:223-238)."""
    width = height = 0
    if ext.lower() in IMAGE_EXTS:
        try:
            width = int(query.get("width", "") or 0)
        except ValueError:
            width = 0
        try:
            height = int(query.get("height", "") or 0)
        except ValueError:
            height = 0
    mode = query.get("mode", "")
    return width, height, mode, (width > 0 or height > 0)
