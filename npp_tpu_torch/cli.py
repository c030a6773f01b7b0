"""Command-line entry point of the PyTorch port.

Usage:
  python -m npp_tpu_torch.cli search --datadir D --outdir O [--device cpu] [overrides]
  python -m npp_tpu_torch.cli complete --datadir D --basedir B [--device cpu] [overrides]
  python -m npp_tpu_torch.cli remap --datadir D --basedir B [--device cpu] [overrides]
  python -m npp_tpu_torch.cli segment --datadir D --basedir B [--device cpu] [overrides]

`search` reads D's masked_img.png, gt_img.png, unknown_mask.png and
valid_mask.png and writes O/<name>/config.odgt and its PNGs, which
`complete --datadir O/<name>` reads; `remap` and `segment` read a
record and its gt_img and valid_mask the same way. Any SearchConfig /
CompletionConfig / RemappingConfig / SegmentationConfig field can be
overridden with --<field> <value>; booleans accept true/false. Runs on the
card unless --device cpu is given. PNGs are read and written by the
port's own codec (utils/png.py), so the CLI runs where OpenCV is absent.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Type

from .config import (CompletionConfig, RemappingConfig, SearchConfig,
                     SegmentationConfig)


def _parse_value(field: dataclasses.Field, raw: str):
    t = str(field.type)
    if 'bool' in t:
        return raw.lower() in ('1', 'true', 'yes', 'on')
    if 'Tuple' in t or 'tuple' in t:  # before int/float: 'Tuple[int,...]'
        return tuple(float(v) if '.' in v else int(v)
                     for v in raw.strip('()').split(','))
    if 'int' in t:
        return int(raw)
    if 'float' in t:
        return float(raw)
    return raw


def build_config(cls: Type, argv):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    overrides = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith('--'):
            raise SystemExit(f'unexpected argument: {arg}')
        key = arg[2:]
        if key not in fields:
            raise SystemExit(f'unknown option --{key} for {cls.__name__}')
        if i + 1 >= len(argv):
            raise SystemExit(f'--{key} requires a value')
        overrides[key] = _parse_value(fields[key], argv[i + 1])
        i += 2
    return cls(**overrides)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ('-h', '--help'):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    device = None
    if '--device' in rest:
        j = rest.index('--device')
        device = rest[j + 1]
        rest = rest[:j] + rest[j + 2:]
    if cmd == 'complete':
        from .models.completion import run_completion
        _, final, _ = run_completion(build_config(CompletionConfig, rest),
                                     device=device)
        print({k: v for k, v in final.items() if not hasattr(v, 'shape')})
    elif cmd == 'remap':
        from .models.remapping import run_remapping
        _, final, _ = run_remapping(build_config(RemappingConfig, rest),
                                    device=device)
        print({k: v for k, v in final.items() if not hasattr(v, 'shape')})
    elif cmd == 'search':
        from .proposal.search import run_search
        odgt = run_search(build_config(SearchConfig, rest), device=device)
        print({k: odgt[k] for k in ('selected_angles', 'selected_periods',
                                    'distances')})
    elif cmd == 'segment':
        from .models.segmentation import run_segmentation
        _, results, _ = run_segmentation(
            build_config(SegmentationConfig, rest), device=device)
        print({i: float(r['non_period_mask'].mean())
               for i, r in results.items()})
    else:
        raise SystemExit(f'unknown command: {cmd}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
