"""The segmentation's coarse mask, the port's against npp_tpu's, on the CPU.

    env JAX_PLATFORMS=cpu python scripts/coarse_mask_vs_npp_tpu.py
        [--seeds 0 1 2 100 101 102]

On the 256x320 synthetic segmentation examples
(npp_tpu_torch/utils/synthetic.py::synthetic_segment_data, a copy of
scripts/eval_segmentation_iou.py::synth_example; the TPU rounds scored
seeds 100-102), runs both packages' coarse_segment at the loader's
defaults (3 classes, superpixels of 20 px, regularisation 0.1) and prints
one JSON line per seed: whether the non-periodic masks (the classes
outside the centre quarter's majority, as the loaders take them) are
equal, and each mask's IoU against the example's ground truth. Needs
npp_tpu and sklearn (the CPU test host), not a card.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def non_periodic(seg, nb=3):
    import numpy as np
    seg = np.uint8(seg + 1)
    h, w = seg.shape
    counts = np.bincount(seg[h // 4: h // 4 * 3, w // 4: w // 4 * 3].ravel(),
                         minlength=nb + 1)[1:]
    return seg != counts.argmax() + 1


def iou(a, b):
    u = (a | b).sum()
    return float((a & b).sum() / u) if u else 1.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seeds', type=int, nargs='+',
                    default=[0, 1, 2, 100, 101, 102])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    from npp_tpu.segmentation import coarse as jax_coarse
    from npp_tpu_torch.segmentation import coarse
    from npp_tpu_torch.utils.synthetic import synthetic_segment_data
    for seed in args.seeds:
        d = synthetic_segment_data(seed)
        img = np.uint8(d['gt_img'] * 255)
        mask = np.ones(img.shape[:2], bool)
        want = non_periodic(jax_coarse.coarse_segment(img, mask))
        got = non_periodic(coarse.coarse_segment(img, mask))
        print(json.dumps({'seed': seed, 'equal': bool((got == want).all()),
                          'iou_port': iou(got, d['gt_mask']),
                          'iou_npp_tpu': iou(want, d['gt_mask'])}),
              flush=True)


if __name__ == '__main__':
    main()
