"""Offline grounding scorer (the port's twin of the root
tools/eval_script.py, reference surface tools/eval_script.py): re-scores
a dumped `test_results.json` against a gt annotation file without
running the model, with the port's `ground_eval` (its exact oriented-box
IoU on the CPU).

    python -m proxytransformation_torch.tools.eval_script RESULTS_JSON
        GT_JSON [--top-k 10]

GT json: list of {'gt_bboxes_3d': [[9 floats], ...], 'is_hard': bool,
'is_view_dep': bool, 'is_unique': bool}.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from ..eval.grounding_metric import ground_eval


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('results')
    parser.add_argument('gt')
    parser.add_argument('--top-k', type=int, default=10)
    args = parser.parse_args(argv)

    with open(args.results) as f:
        results = json.load(f)
    with open(args.gt) as f:
        gt = json.load(f)

    det_annos = [{
        'bboxes_3d': np.asarray(r['bboxes_3d'], np.float32),
        'target_scores_3d': np.asarray(r['scores_3d'], np.float32),
    } for r in results]
    gt_annos = [{
        'gt_bboxes_3d': np.asarray(g['gt_bboxes_3d'], np.float32),
        'is_hard': bool(g.get('is_hard', False)),
        'is_view_dep': bool(g.get('is_view_dep', False)),
        'is_unique': bool(g.get('is_unique', False)),
    } for g in gt]

    ret = ground_eval(gt_annos, det_annos, top_k=args.top_k)
    print(json.dumps({k: round(v, 4) for k, v in ret.items()}, indent=2))


if __name__ == '__main__':
    main()
