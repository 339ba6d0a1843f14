"""ScanNet `.sens` raw-data extractor (the JAX package's
converter/scannet_sens.py; reference converter/generate_image_scannet.py:
1-201, itself after ScanNet's public SensReader): parses the version-4
.sens binary layout (header with color/depth intrinsics/extrinsics, then
per-frame camera_to_world + jpeg color + zlib ushort depth) and dumps
color/depth/pose files. The depth PNGs are written by the port's own
encoder (`data/image_io.py::write_png`), where the JAX package calls
cv2.imwrite: the same pixels, read back by either decoder.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

from ..data.image_io import write_png

COMPRESSION_TYPE_COLOR = {-1: 'unknown', 0: 'raw', 1: 'png', 2: 'jpeg'}
COMPRESSION_TYPE_DEPTH = {-1: 'unknown', 0: 'raw_ushort', 1: 'zlib_ushort',
                          2: 'occi_ushort'}


class SensReader:
    """Streaming .sens parser (does not hold all frames in memory)."""

    VERSION = 4

    def __init__(self, filename: str):
        self.filename = filename
        self._parse_header()

    def _read_mat4(self, f) -> np.ndarray:
        return np.asarray(struct.unpack('f' * 16, f.read(64)),
                          np.float32).reshape(4, 4)

    def _parse_header(self):
        with open(self.filename, 'rb') as f:
            version = struct.unpack('I', f.read(4))[0]
            if version != self.VERSION:
                raise ValueError(f'{self.filename}: unsupported .sens '
                                 f'version {version}')
            strlen = struct.unpack('Q', f.read(8))[0]
            self.sensor_name = f.read(strlen).decode('ascii', 'replace')
            self.intrinsic_color = self._read_mat4(f)
            self.extrinsic_color = self._read_mat4(f)
            self.intrinsic_depth = self._read_mat4(f)
            self.extrinsic_depth = self._read_mat4(f)
            self.color_compression = COMPRESSION_TYPE_COLOR[
                struct.unpack('i', f.read(4))[0]]
            self.depth_compression = COMPRESSION_TYPE_DEPTH[
                struct.unpack('i', f.read(4))[0]]
            self.color_width = struct.unpack('I', f.read(4))[0]
            self.color_height = struct.unpack('I', f.read(4))[0]
            self.depth_width = struct.unpack('I', f.read(4))[0]
            self.depth_height = struct.unpack('I', f.read(4))[0]
            self.depth_shift = struct.unpack('f', f.read(4))[0]
            self.num_frames = struct.unpack('Q', f.read(8))[0]
            self._frames_offset = f.tell()

    def frames(self) -> Iterator[Tuple[np.ndarray, bytes, np.ndarray]]:
        """Yield (camera_to_world, color_jpeg_bytes, depth_u16)."""
        with open(self.filename, 'rb') as f:
            f.seek(self._frames_offset)
            for _ in range(self.num_frames):
                pose = self._read_mat4(f)
                f.read(16)  # two uint64 timestamps
                color_bytes = struct.unpack('Q', f.read(8))[0]
                depth_bytes = struct.unpack('Q', f.read(8))[0]
                color = f.read(color_bytes)
                depth_raw = f.read(depth_bytes)
                if self.depth_compression == 'zlib_ushort':
                    depth_raw = zlib.decompress(depth_raw)
                depth = np.frombuffer(depth_raw, np.uint16).reshape(
                    self.depth_height, self.depth_width)
                yield pose, color, depth


def extract_scannet_images(sens_path: str, out_dir: str,
                           frame_skip: int = 1,
                           max_frames: Optional[int] = None) -> int:
    """Dump color jpgs, 16-bit depth pngs and poses from a .sens file."""
    reader = SensReader(sens_path)
    for sub in ('color', 'depth', 'pose'):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    np.savetxt(os.path.join(out_dir, 'intrinsic_color.txt'),
               reader.intrinsic_color)
    np.savetxt(os.path.join(out_dir, 'intrinsic_depth.txt'),
               reader.intrinsic_depth)
    n = 0
    for i, (pose, color_jpeg, depth) in enumerate(reader.frames()):
        if i % frame_skip:
            continue
        with open(os.path.join(out_dir, 'color', f'{i:06d}.jpg'), 'wb') as f:
            f.write(color_jpeg)
        write_png(os.path.join(out_dir, 'depth', f'{i:06d}.png'), depth)
        np.savetxt(os.path.join(out_dir, 'pose', f'{i:06d}.txt'), pose)
        n += 1
        if max_frames and n >= max_frames:
            break
    return n
