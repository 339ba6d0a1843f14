"""3RScan raw-data extractor (the JAX package's converter/rscan.py;
reference embodiedscan/converter/generate_image_3rscan.py:1-27): each
3RScan scene ships a `sequence.zip` of color/depth/pose frames; extract
it to `sequence/` so the dataset's image loader can read the frames.
Scenes go to a pool of spawned processes (the reference uses mmengine's
track_parallel_progress).

    python -m proxytransformation_torch.converter.rscan \
        --dataset_folder DIR [--nproc 8]
"""
from __future__ import annotations

import os
import zipfile
import multiprocessing
from typing import List, Optional, Sequence


def extract_scene(dataset_folder: str, scene_name: str) -> Optional[str]:
    """Unzip one scene's sequence.zip; returns the output dir or None."""
    zip_path = os.path.join(dataset_folder, scene_name, 'sequence.zip')
    if not os.path.isfile(zip_path):
        return None
    out_dir = os.path.join(dataset_folder, scene_name, 'sequence')
    with zipfile.ZipFile(zip_path, 'r') as zf:
        zf.extractall(out_dir)
    return out_dir


def extract_3rscan_images(dataset_folder: str,
                          scenes: Optional[Sequence[str]] = None,
                          nproc: int = 8) -> List[str]:
    """Extract every scene's frame sequence; returns extracted dirs."""
    if scenes is None:
        scenes = sorted(
            d for d in os.listdir(dataset_folder)
            if os.path.isdir(os.path.join(dataset_folder, d)))
    if nproc > 1:
        with multiprocessing.get_context('spawn').Pool(nproc) as pool:
            outs = pool.starmap(extract_scene,
                                [(dataset_folder, s) for s in scenes])
    else:
        outs = [extract_scene(dataset_folder, s) for s in scenes]
    return [o for o in outs if o]


def main():
    from argparse import ArgumentParser
    parser = ArgumentParser()
    parser.add_argument('--dataset_folder', required=True,
                        help='folder of the 3RScan dataset')
    parser.add_argument('--nproc', type=int, default=8)
    args = parser.parse_args()
    done = extract_3rscan_images(args.dataset_folder, nproc=args.nproc)
    print(f'extracted {len(done)} scenes')


if __name__ == '__main__':
    main()
