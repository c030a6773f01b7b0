"""scripts/torch_eval_remapping.py on the CPU: its own copies of
scripts/eval_remapping.py's functions (the square-wave example, unsharp
masking, PSNR, bbox LPIPS) against that script's, imported by path (cv2 is
installed here), and a tiny run of the harness.

Tolerances: the example, unsharp and PSNR within 1e-12 (scipy's mirror
Gaussian against cv2's reflect-101 one, both float64: ~1e-15 apart); bbox
LPIPS within 1e-5 (the port's VGG16 tower against npp_tpu's, f32)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

import npp_tpu_torch.config as TC
from npp_tpu_torch.losses.lpips import LPIPS
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_SCRIPT = _load('eval_remapping', 'scripts/eval_remapping.py')
PORT = _load('torch_eval_remapping', 'scripts/torch_eval_remapping.py')


@pytest.mark.parametrize('seed', [300, 301])
def test_synth_blur_example_matches_script(seed):
    got = PORT.synth_blur_example(seed)
    want = JAX_SCRIPT.synth_blur_example(seed)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[2], want[2])
    assert 0.1 < got[2].mean() < 0.3


@pytest.mark.parametrize('amount', [1.5, 3.0])
def test_unsharp_and_psnr_match_script(amount):
    sharp, blurred, mask = PORT.synth_blur_example(300)
    got = PORT.unsharp(blurred, mask, 2.0, amount)
    want = JAX_SCRIPT.unsharp(blurred, mask, 2.0, amount)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for m in (mask, ~mask):
        assert abs(PORT.psnr(got, sharp, m) -
                   JAX_SCRIPT.psnr(want, sharp, m)) < 1e-12


def _window(sharp, blurred, mask, h, w):
    """An h x w window across the blur region's right edge, so it holds
    blurred and clear pixels."""
    ys, xs = np.nonzero(mask)
    y = int(np.clip(ys[xs.argmax()] - h // 2, 0, mask.shape[0] - h))
    x = int(np.clip(xs.max() - w // 2, 0, mask.shape[1] - w))
    return tuple(a[y:y + h, x:x + w] for a in (sharp, blurred, mask))


def test_bbox_lpips_matches_script():
    sharp, blurred, mask = _window(*PORT.synth_blur_example(301), 64, 64)
    assert 0 < mask.mean() < 1
    pred = PORT.unsharp(blurred, mask, 2.0, 3.0)
    got = PORT.bbox_lpips(LPIPS(CPU, net='vgg'), pred, sharp, mask, CPU)
    want = JAX_SCRIPT.bbox_lpips(pred, sharp, mask)
    assert abs(got - want) < 1e-5 and want > 0


# the JAX script's record keys (scripts/eval_remapping.py:206-224, 237-251)
def _record_keys(arms):
    keys = {'example', 'blur_frac'}
    for b in ('identity', 'unsharp_1.5', 'unsharp_3'):
        keys |= {f'psnr_blur_{b}', f'lpips_blur_{b}'}
    for arm in arms:
        keys |= {f'psnr_blur_ours_{arm}', f'lpips_blur_ours_{arm}',
                 f'psnr_clear_ours_{arm}', f'iters_per_sec_{arm}'}
    return keys


def test_tiny_run_writes_the_scripts_keys(tmp_path, monkeypatch, capsys):
    """One example cut to 64x80 across the blur region's edge, narrow
    nets, a 5-step search and 8-step fits per arm on the CPU: one record
    line with the JAX script's keys (both arms), the summary line, the
    records file, the inputs, and a run log with each fit's wall."""
    import json
    full = PORT.synth_blur_example
    monkeypatch.setattr(PORT, 'synth_blur_example',
                        lambda seed: _window(*full(seed), 64, 80))
    remap, search = TC.RemappingConfig, TC.SearchConfig
    monkeypatch.setattr(TC, 'RemappingConfig', lambda: TC.replace(
        remap(), netwidth=32, netdepth=2, N_rand=128, patch_num=1,
        num_real_patch_per_sample=2, i_print=4))
    monkeypatch.setattr(TC, 'SearchConfig', lambda: TC.replace(
        search(), netwidth=32, netdepth=2, N_rand=128))
    records = PORT.main(['--device', 'cpu', '--n-synth', '1',
                         '--iters-scale', '0.003', '--search-iters', '5',
                         '--ab-style', '--out', str(tmp_path)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{')]
    assert lines[0] == records[0] and len(lines) == 2
    assert set(records[0]) == _record_keys(('ref', 'style0'))
    assert all(np.isfinite(v) for k, v in records[0].items()
               if k != 'example')
    assert set(lines[1]['summary']) == {
        'beats_best_baseline_psnr', 'beats_best_baseline_lpips', 'total'}
    with open(tmp_path / 'remap_records.json') as f:
        assert json.load(f) == records
    with open(tmp_path / 'remap_runs.json') as f:
        runs = json.load(f)
    assert [r['arm'] for r in runs['fits']] == ['ref', 'style0']
    assert all(r['wall_s'] > 0 for r in runs['fits'] + runs['searches'])
    in_dir = tmp_path / 'input' / 'synth_blur0'
    for f in ('gt_img.png', 'masked_img.png', 'unknown_mask.png',
              'valid_mask.png', 'sharp_gt.npy', 'blur_mask.npy'):
        assert (in_dir / f).exists(), f
    assert np.load(in_dir / 'sharp_gt.npy').shape == (64, 80, 3)
