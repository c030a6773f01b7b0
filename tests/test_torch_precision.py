"""The port's matmul precision scope (device.py::matmul_precision) and where
the fit applies it: npp_tpu runs the loss, its gradient and the render
under jax.default_matmul_precision(cfg.matmul_precision), which on a card
with TF32 tensor cores is TF32 for the names JAX maps to DEFAULT or HIGH.
This file imports no JAX, so on the card's machine it runs without
tests/conftest.py: `python -m pytest --noconftest -m cuda
tests/test_torch_precision.py`."""
import numpy as np
import pytest
import torch

from npp_tpu_torch.config import CompletionConfig, replace
from npp_tpu_torch.device import TF32_BY_PRECISION, matmul_precision
from npp_tpu_torch.models.loaders import TaskData
from npp_tpu_torch.models.pipeline import build_components, make_fit_consts
from npp_tpu_torch.models.trainer import (init_fit_state, make_fit_block,
                                          make_render)

TF32_NAMES = ('bfloat16', 'default', 'fastest', 'tensorfloat32',
              'bfloat16_3x', 'high')


def flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def restore_flags():
    before = flags()
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = before


@pytest.mark.parametrize('name', TF32_NAMES + ('float32', 'highest'))
def test_names_set_tf32_and_restore_it(name, restore_flags):
    want = name in TF32_NAMES
    assert TF32_BY_PRECISION[name] == want
    assert set(TF32_BY_PRECISION) == set(TF32_NAMES) | {'float32', 'highest'}
    for before in ((True, False), (False, True)):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
        with matmul_precision(name):
            assert flags() == (want, want)
        assert flags() == before


def test_restores_on_an_exception_and_rejects_unknown_names(restore_flags):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    with pytest.raises(KeyError):
        with matmul_precision('bfloat16'):
            assert flags() == (True, True)
            raise KeyError('inside')
    assert flags() == (False, True)
    for bad in ('float16', 'BFLOAT16', ''):
        with pytest.raises(ValueError):
            with matmul_precision(bad):
                pass
        assert flags() == (False, True)


def test_cpu_results_are_bit_identical(restore_flags):
    """The flags steer cuBLAS and cuDNN only: a CPU matmul, convolution and
    their gradients give the same bits under every name."""
    rng = np.random.RandomState(0)
    a = torch.tensor(rng.randn(64, 512), dtype=torch.float32)
    b = torch.tensor(rng.randn(512, 256), dtype=torch.float32)
    img = torch.tensor(rng.randn(2, 3, 20, 20), dtype=torch.float32)
    k = torch.tensor(rng.randn(8, 3, 3, 3), dtype=torch.float32)

    def run():
        ai, ki = a.clone().requires_grad_(), k.clone().requires_grad_()
        y = ai @ b
        z = torch.nn.functional.conv2d(img, ki, padding=1)
        (y.square().sum() + z.square().sum()).backward()
        return [y, z, ai.grad, ki.grad]

    want = run()
    for name in ('bfloat16', 'float32', 'high'):
        with matmul_precision(name):
            got = run()
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


def _tiny_data(h=40, w=48):
    """tests/test_torch_trainer.py::_tiny_arrays's example."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * yy / 10.0),
                    0.5 + 0.4 * np.cos(2 * np.pi * xx / 12.0),
                    0.5 * np.ones_like(yy)], -1)
    mask = np.ones((h, w, 1))
    mask[15:22, 18:28] = 0
    return TaskData(img=img, masked_img=img * mask, mask=mask,
                    valid_mask=np.ones((h, w, 1)),
                    i_train=np.stack(np.nonzero(mask[..., 0]), 1),
                    i_val=np.stack(np.nonzero(1 - mask[..., 0]), 1),
                    selected_shifts=[[[12.0, 0.0], [0.0, 10.0]]] * 3,
                    selected_angles=[[90.0, 180.0]] * 3,
                    selected_periods=[[10.0, 12.0]] * 3, patch_size=16)


@pytest.mark.parametrize('device', ['cpu',
                                    pytest.param('cuda',
                                                 marks=pytest.mark.cuda)])
@pytest.mark.parametrize('name', ['bfloat16', 'float32'])
def test_fit_steps_and_render_run_under_the_precision(device, name,
                                                      restore_flags):
    """A fit block's forward and backward (flags read by a gradient hook on
    the MLP's first weight, as loss.backward() reaches it) and the render
    (a forward hook on the MLP) run under cfg.matmul_precision; the flags
    come back afterwards. Pixel loss only, tiny widths."""
    if device == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(CompletionConfig(), netwidth=32, netdepth=6, N_rand=64,
                  patch_num=1, num_real_patch_per_sample=2,
                  use_contextual_loss=False, use_perceptual_loss=False,
                  matmul_precision=name)
    data = _tiny_data()
    comps = build_components(cfg, data, dev)
    state = init_fit_state(cfg, comps.model, None, dev)
    seen = {'backward': [], 'forward': []}
    weight = next(comps.model.parameters())
    weight.register_hook(lambda g: seen['backward'].append(flags()))
    run_block = make_fit_block(cfg, comps.embedder,
                               make_fit_consts(cfg, data, 16, dev), None,
                               None, 1, 16, 2)
    run_block(state, torch.Generator().manual_seed(0))
    comps.model.register_forward_hook(
        lambda *_: seen['forward'].append(flags()))
    make_render(cfg, comps.embedder)(state.params, 40, 48)
    want = (name == 'bfloat16',) * 2
    assert seen['backward'] == [want, want]
    assert seen['forward'] and set(seen['forward']) == {want}
    assert flags() == (False, False)
