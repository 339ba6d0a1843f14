"""Write the image fixtures of the decoder tests and of chip_smoke.py.

    python -m proxytransformation_torch.tools.make_image_fixtures

writes `tests/torch_port_images/`: two 640x480 RGB-D views of a
ray-cast room (a JPEG at cv2's default 4:2:0 and quality 95, and a 16-bit
PNG depth map in millimetres, 0 where the ray leaves the room), small
JPEGs at 4:2:2, 4:4:4, 4:4:0, grayscale, quality 50 and 100, one with
restart markers and odd sizes (1x1, 7x9, 97x131), 8-bit gray and RGB PNGs,
and `manifest.json`: for each file its kind, the cv2 flag it is read with,
the shape and dtype of `cv2.imread`'s array and the sha256 of that
array's bytes (the decoder must reproduce those digests wherever it
runs); and for the two views their camera-to-world poses, the intrinsics
and the room's boxes (center, size, zero euler angles), from which
chip_smoke.py writes an EmbodiedScan-style scan.

This tool needs cv2 (OpenCV's encoders and decoders are the reference);
the port itself never imports it. The fixtures are drawn from a fixed
seed.
"""
from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path

import numpy as np

OUT_DIR = Path(__file__).resolve().parents[2] / 'tests' / 'torch_port_images'
H, W = 480, 640
# ScanNet-style pinhole intrinsics of a 640x480 view
FX = FY = 577.87
CX, CY = 319.5, 239.5
ROOM = np.array([[-2.5, -2.0, 0.0], [3.0, 2.5, 2.8]])   # min / max corners
ORIGIN = np.array([0.2, 0.1, 1.5])                       # the camera
BOXES = (((1.0, -1.2, 0.0), (1.9, -0.3, 0.75)),
         ((-1.8, 1.0, 0.0), (-0.9, 2.0, 1.1)),
         ((1.6, 1.2, 0.0), (2.4, 2.2, 0.45)))
POSES = ((0.35, 0.25), (2.2, 0.35))                      # yaw, pitch


def cam2global(yaw: float, pitch: float) -> np.ndarray:
    """4x4 camera-to-world pose of a camera at ORIGIN looking along `yaw`,
    tilted down by `pitch` (camera: x right, y down, z forward)."""
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    fwd = np.array([cy * cp, sy * cp, -sp])
    right = np.array([sy, -cy, 0.0])
    pose = np.eye(4)
    pose[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)
    pose[:3, 3] = ORIGIN
    return pose


def cam_rays(yaw: float, pitch: float):
    """World-frame unit rays of every pixel, and their camera-frame z."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.stack([(u - CX) / FX, (v - CY) / FY, np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d @ cam2global(yaw, pitch)[:3, :3].T, d[..., 2]


def render(yaw: float, pitch: float, boxes, seed: int):
    """Depth (mm, uint16) and BGR color of the room and its boxes."""
    rng = np.random.RandomState(seed)
    origin = ORIGIN
    rays, cos_z = cam_rays(yaw, pitch)
    t_best = np.full((H, W), np.inf)
    surf = np.zeros((H, W), np.int64)
    safe = np.where(np.abs(rays) < 1e-9, 1e-9, rays)
    for axis in range(3):     # the room's six inner faces
        for side in range(2):
            t = (ROOM[side, axis] - origin[axis]) / safe[..., axis]
            ok = (t > 0) & (t < t_best)
            t_best = np.where(ok, t, t_best)
            surf = np.where(ok, 1 + axis * 2 + side, surf)
    for i, (lo, hi) in enumerate(boxes):  # slab test against each box
        t0 = (np.asarray(lo) - origin) / safe
        t1 = (np.asarray(hi) - origin) / safe
        near = np.minimum(t0, t1).max(-1)
        far = np.maximum(t0, t1).min(-1)
        ok = (near < far) & (near > 0) & (near < t_best)
        t_best = np.where(ok, near, t_best)
        surf = np.where(ok, 10 + i, surf)
    depth_m = t_best * cos_z             # distance along the optical axis
    depth_m += rng.normal(0, 0.004, depth_m.shape)
    depth = np.clip(depth_m * 1000, 0, 65535).astype(np.uint16)
    depth[rng.rand(H, W) < 0.03] = 0     # dropouts, as in sensor data
    depth[:, :6] = 0                     # an invalid border column band
    palette = rng.randint(40, 230, (32, 3))
    hit = origin + rays * t_best[..., None]
    texture = (np.sin(hit[..., 0] * 7) + np.sin(hit[..., 1] * 5)
               + np.sin(hit[..., 2] * 9)) * 12
    shade = 0.55 + 0.45 * np.clip(1.5 / np.maximum(depth_m, 0.3), 0, 1)
    color = palette[surf] * shade[..., None] + texture[..., None]
    color += rng.normal(0, 6, color.shape)   # sensor noise: photo-like entropy
    return depth, np.clip(color, 0, 255).astype(np.uint8)


def small(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    (x + y) % 32 * 8], -1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def main(argv=None) -> None:
    import cv2   # the fixture tool only: OpenCV is the reference

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--out', default=str(OUT_DIR))
    args = parser.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sampling = {'420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                '444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
    files = []   # (name, array, encode params, read flag)
    for i, (yaw, pitch) in enumerate(POSES):
        depth, color = render(yaw, pitch, BOXES, seed=i)
        files.append((f'view{i}_640x480.jpg', color,
                      [cv2.IMWRITE_JPEG_QUALITY, 95], cv2.IMREAD_COLOR))
        files.append((f'depth{i}_640x480.png', depth, [],
                      cv2.IMREAD_UNCHANGED))
    base = small(48, 64, 10)
    for name, samp in sampling.items():
        if name != '420':
            files.append((f'small_{name}_q90.jpg', base,
                          [cv2.IMWRITE_JPEG_QUALITY, 90,
                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp],
                          cv2.IMREAD_COLOR))
    files += [
        ('small_gray_q90.jpg', base[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 90],
         cv2.IMREAD_COLOR),
        ('small_q50.jpg', base, [cv2.IMWRITE_JPEG_QUALITY, 50],
         cv2.IMREAD_COLOR),
        ('small_q100.jpg', base, [cv2.IMWRITE_JPEG_QUALITY, 100],
         cv2.IMREAD_COLOR),
        ('small_rst2.jpg', base, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                  cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
         cv2.IMREAD_COLOR),
        ('odd_1x1.jpg', small(1, 1, 11), [], cv2.IMREAD_COLOR),
        ('odd_7x9.jpg', small(7, 9, 12), [], cv2.IMREAD_COLOR),
        ('odd_97x131.jpg', small(97, 131, 13), [], cv2.IMREAD_COLOR),
        ('gray8_37x29.png', small(29, 37, 14)[..., 0], [],
         cv2.IMREAD_UNCHANGED),
        ('rgb8_37x29.png', small(29, 37, 15), [], cv2.IMREAD_UNCHANGED),
    ]
    manifest = []
    for name, arr, params, flag in files:
        path = out / name
        if not cv2.imwrite(str(path), arr, params):
            raise RuntimeError(f'cv2 could not write {path}')
        got = cv2.imread(str(path), flag)
        manifest.append({
            'name': name, 'kind': path.suffix[1:].replace('jpg', 'jpeg'),
            'flags': 'IMREAD_COLOR' if flag == cv2.IMREAD_COLOR
            else 'IMREAD_UNCHANGED',
            'shape': list(got.shape), 'dtype': str(got.dtype),
            'sha256': hashlib.sha256(
                np.ascontiguousarray(got).tobytes()).hexdigest()})
    meta = {'generator': 'proxytransformation_torch/tools/'
                         'make_image_fixtures.py',
            'cv2': cv2.__version__,
            'cam2img': [[FX, 0, CX, 0], [0, FY, CY, 0], [0, 0, 1, 0],
                        [0, 0, 0, 1]],
            'depth_shift': 1000,
            'views': [{'image': f'view{i}_640x480.jpg',
                       'depth': f'depth{i}_640x480.png',
                       'cam2global': cam2global(*p).round(12).tolist()}
                      for i, p in enumerate(POSES)],
            'boxes': [[round(float(v), 6) for v in (
                *np.add(lo, hi) / 2, *np.subtract(hi, lo), 0, 0, 0)]
                for lo, hi in BOXES],
            'files': manifest}
    (out / 'manifest.json').write_text(json.dumps(meta, indent=1) + '\n')
    total = sum((out / f['name']).stat().st_size for f in manifest)
    print(f'{len(manifest)} fixtures, {total / 1e6:.2f} MB, in {out}')


if __name__ == '__main__':
    main()
