"""Byte-cost models for the uplink video path (§3.2 "Compression").

No video encoder is bundled; deployments plug a real encoder in here.
The constants are calibrated to the paper's reported operating points:

  * H.264 two-pass over a T_update buffer of sampled frames targets 200 Kbps
    (paper: "a target bitrate of 200 Kbps"), with efficiency degrading when
    fewer frames share the buffer (intra-coded only).
  * A good-quality JPEG at 1024x512 is ~87.5 KB (paper footnote 2:
    ~700 Kbps at 1 fps), used by Remote+Tracking which cannot buffer.

Costs scale linearly in pixel count relative to the reference resolution.
"""
from __future__ import annotations

REF_PIXELS = 1024 * 512
JPEG_BYTES_REF = 87_500  # ~700 Kbps at 1 fps (paper footnote 2)
H264_TARGET_BPS = 200_000  # two-pass target bitrate (paper §4.1)
H264_MIN_FRAME_FRACTION = 0.25  # intra floor: a lone frame still costs >= this of JPEG


def jpeg_bytes(n_pixels: int, quality_scale: float = 1.0) -> int:
    return int(JPEG_BYTES_REF * (n_pixels / REF_PIXELS) * quality_scale)


def h264_buffer_bytes(n_frames: int, n_pixels: int, t_update: float) -> int:
    """Encoding a buffer of n_frames sampled over t_update seconds."""
    if n_frames <= 0:
        return 0
    rate_bytes = int(H264_TARGET_BPS * t_update / 8 * (n_pixels / REF_PIXELS))
    floor = int(n_frames * jpeg_bytes(n_pixels) * H264_MIN_FRAME_FRACTION)
    return min(max(rate_bytes, 1), max(floor, 1)) if n_frames == 1 else min(
        rate_bytes, n_frames * jpeg_bytes(n_pixels)
    )
