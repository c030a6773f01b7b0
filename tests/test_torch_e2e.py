"""End to end on the CPU: the port's run_completion (loader, embedder,
sampler, fit blocks with the canvas table, render, composite, IO) against
`npp_tpu`'s on the synthetic example directory of
tests/test_e2e_completion.py, at the same budget. The two packages draw
different random numbers (bands, init, batches), so the comparison is at
the trajectory level (PARITY.md deviation 1): the final train PSNR within
2 dB, and the hole's PSNR no more than 2 dB below. The patch losses are
off to keep the JAX compile short; tests/test_torch_trainer.py holds them
to `npp_tpu` step by step."""
import os

import numpy as np

from tests.test_e2e_completion import example_dir  # noqa: F401  (fixture)
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

BUDGET = dict(netwidth=32, netdepth=4, N_rand=256, patch_num=1,
              num_real_patch_per_sample=2, N_iters=41, i_testset=20,
              i_print=20, use_perceptual_loss=False,
              use_contextual_loss=False)
MARGIN_DB = 2.0


def test_run_completion_tracks_jax(example_dir, tmp_path):  # noqa: F811
    from npp_tpu.config import CompletionConfig as JaxCompletionConfig
    from npp_tpu.config import replace as jax_replace
    from npp_tpu.models.completion import run_completion as jax_run
    from npp_tpu_torch.config import CompletionConfig, replace
    from npp_tpu_torch.kernels import launch_counts
    from npp_tpu_torch.models.completion import run_completion

    _, jfinal, _ = jax_run(jax_replace(
        JaxCompletionConfig(), datadir=example_dir,
        basedir=str(tmp_path / 'jax'), **BUDGET), save=False)
    cfg = replace(CompletionConfig(), datadir=example_dir,
                  basedir=str(tmp_path / 'port'), **BUDGET)
    result, final, evals = run_completion(cfg, save=True, device='cpu')

    assert sorted(evals) == [20, 40]
    assert len(result.history) == 2
    assert abs(final['train_psnr'] - jfinal['train_psnr']) < MARGIN_DB, (
        final['train_psnr'], jfinal['train_psnr'])
    assert final['val_psnr'] > jfinal['val_psnr'] - MARGIN_DB, (
        final['val_psnr'], jfinal['val_psnr'])
    # the fit improved from its first evaluation
    assert final['train_psnr'] > evals[20]['train_psnr'] - 0.5
    assert np.isfinite(final['val_lpips'])
    # the final eval makes the seam outputs at the default comp_seam too
    assert 'pred_rgb_img_comp_seam' in final
    assert np.isfinite(final['val_psnr_seam'])
    assert np.isfinite(final['val_lpips_seam'])
    # on the CPU every wrapper takes its plain version: no kernel launched
    assert not any(launch_counts().values())
    name = example_dir.rstrip('/').split('/')[-1]
    out = os.path.join(str(tmp_path / 'port'), 'completion_top3', name)
    for d in ('testset_000040', 'testset_final'):
        assert os.path.exists(os.path.join(out, d, 'pred_rgb_img_comp.png'))


def test_cli_complete_runs_on_the_cpu(example_dir, tmp_path, capsys):  # noqa: F811
    from npp_tpu_torch.cli import main
    assert main(['complete', '--datadir', example_dir, '--basedir',
                 str(tmp_path), '--device', 'cpu', '--netwidth', '16',
                 '--netdepth', '2', '--N_rand', '64', '--patch_num', '1',
                 '--num_real_patch_per_sample', '2', '--N_iters', '3',
                 '--i_testset', '2', '--i_print', '2',
                 '--use_perceptual_loss', 'false']) == 0
    assert 'val_psnr' in capsys.readouterr().out
    # segment reads the same record's gt_img and valid_mask (superpixels
    # of 8 px, so the 48x56 image has enough of them for three classes)
    seg = tmp_path / 'seg'
    assert main(['segment', '--datadir', example_dir, '--basedir', str(seg),
                 '--device', 'cpu', '--netwidth', '16', '--netdepth', '2',
                 '--N_rand', '64', '--patch_num', '1',
                 '--num_real_patch_per_sample', '2', '--N_iters', '3',
                 '--i_testset', '2', '--i_print', '2', '--sp_size', '8']) == 0
    name = example_dir.rstrip('/').split('/')[-1]
    out = os.path.join(str(seg), 'segmentation_top3', name)
    assert os.path.exists(os.path.join(out, 'segment_init.png'))
    for f in ('segment.png', 'segment_mask.png', 'lpips_diff_img_0.png'):
        assert os.path.exists(os.path.join(out, 'testset_000002', f)), f


def test_cli_search_then_complete_on_the_cpu(example_dir, tmp_path,  # noqa: F811
                                             capsys):
    """`search` writes a record and its PNGs that `complete` then reads."""
    from npp_tpu_torch.cli import main
    out = str(tmp_path / 'det')
    assert main(['search', '--datadir', example_dir, '--outdir', out,
                 '--device', 'cpu', '--netwidth', '16', '--netdepth', '2',
                 '--N_rand', '64', '--N_iters', '3',
                 '--search_range', '2,5,1']) == 0
    assert 'selected_periods' in capsys.readouterr().out
    name = example_dir.rstrip('/').split('/')[-1]
    assert main(['complete', '--datadir', os.path.join(out, name),
                 '--basedir', str(tmp_path / 'res'), '--device', 'cpu',
                 '--netwidth', '16', '--netdepth', '2', '--N_rand', '64',
                 '--patch_num', '1', '--num_real_patch_per_sample', '2',
                 '--N_iters', '3', '--i_testset', '2', '--i_print', '2',
                 '--use_perceptual_loss', 'false',
                 '--use_contextual_loss', 'false']) == 0
    assert 'val_psnr' in capsys.readouterr().out
