"""Port parity on the CPU: embedder (K1's plain version), MLP (K2's plain
version), config and the import guard. The same numpy inputs go through
`npp_tpu` and `npp_tpu_torch`; parameters and Fourier bands are carried
across with `params_from_jax`."""
import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npp_tpu.config import CompletionConfig as JaxCompletionConfig
from npp_tpu.nn import embedder as JE
from npp_tpu.nn.mlp import NPPNet as JaxNPPNet
from npp_tpu_torch import config as TC
from npp_tpu_torch.nn import embedder as TE
from npp_tpu_torch.nn.mlp import NPPNet, NPPNetTop1
from npp_tpu_torch.utils.convert import params_from_jax
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, 'tests', 'goldens')
OFFSETS = (0.0, -1.0, 1.0, 0.5, -0.5)

# f32 trig argument reduction differs between XLA and PyTorch's CPU kernels
# by ~1e-5 absolute at the embedding's argument sizes (the same note as
# tests/test_trainer.py:114-121); 1e-4 leaves a decade of headroom.
EMBED_ATOL = 1e-4


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_fourier_and_periodic_warp_match_goldens():
    g = np.load(os.path.join(GOLDEN_DIR, 'embedder.npz'))
    bands = _t(2.0 ** np.linspace(0.0, 9.0, 10))
    out = TE.fourier_encode(_t(g['coords']), bands)
    # tolerance of tests/test_embedder.py for the same goldens
    np.testing.assert_allclose(out.numpy(), g['fourier_out'], rtol=1e-5,
                               atol=EMBED_ATOL)
    res = tuple(int(v) for v in g['res'])
    for include, key in ((True, 'periodic_out'), (False, 'periodic_search_out')):
        out = TE.periodic_warp(_t(g['coords_yx2']), _t(g['angles']),
                               _t(g['periods']), (1,), OFFSETS, (0,), res,
                               include_input=include)
        np.testing.assert_allclose(out.numpy(), g[key], rtol=1e-4,
                                   atol=EMBED_ATOL)


@pytest.mark.parametrize('i_embed', [0, -1])
def test_task_embedder_matches_jax(i_embed):
    """K1's plain version vs npp_tpu's TaskEmbedder, bands carried across,
    including angle 180 (negative projections: the floored modulo)."""
    cfg = dataclasses.replace(JaxCompletionConfig(), i_embed=i_embed)
    angles = np.array([[100.0, 170.0], [10.0, 180.0], [90.0, 180.0]])
    periods = np.array([[37.0, 43.0], [20.0, 25.0], [48.0, 56.0]])
    res = (120, 180)
    je = JE.make_task_embedder(cfg, angles, periods, res,
                               jax.random.PRNGKey(0))
    tcfg = TC.replace(TC.CompletionConfig(), i_embed=i_embed)
    te = TE.make_task_embedder(tcfg, angles, periods, res,
                               torch.Generator().manual_seed(0),
                               torch.device('cpu'))
    assert (te.out_dim, te.top1_dim) == (je.out_dim, je.top1_dim)
    if i_embed == 0:
        conv = params_from_jax({'embedder': {
            'freq_bands': np.asarray(je.freq_bands)}})
        te.freq_bands = conv['embedder']['freq_bands']
    rng = np.random.RandomState(0)
    coords = np.stack([rng.randint(0, 120, 257), rng.randint(0, 180, 257)],
                      -1).astype(np.float32)
    want = np.asarray(je.embed(jnp.asarray(coords)))
    got = te.embed(_t(coords)).numpy()
    assert got.shape == want.shape == (257, te.out_dim)
    np.testing.assert_allclose(got, want, atol=EMBED_ATOL)

    # the canvas table gathers the same function at integer pixels
    table = TE.make_embedding_table(te, chunk=4096)
    np.testing.assert_allclose(table.embed(_t(coords)).numpy(), got, atol=0)


def _jax_mlp(model, in_dim, seed=0):
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, in_dim)))
    return jax.tree.map(np.asarray, params['params'])


def test_nppnet_outputs_and_grads_match_jax():
    """Snake MLP (K2's plain version on the CPU) vs flax NPPNet, same
    weights: f32 matmul reassociation only, so rtol 1e-4."""
    jm = JaxNPPNet(input_ch_periodic=46, input_ch_periodic_aux=92, depth=4,
                   width=32)
    jp = _jax_mlp(jm, 138)
    tm = NPPNet(46, 92, depth=4, width=32)
    tm.load_state_dict(params_from_jax({'mlp': jp})['mlp'])
    x = np.random.RandomState(1).randn(17, 138).astype(np.float32)

    def jloss(p):
        y = jm.apply({'params': p}, jnp.asarray(x))
        return jnp.sum(jnp.sin(y)), y

    (jl, jy), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    y = tm(_t(x))
    torch.sum(torch.sin(y)).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    for name, p in jg.items():
        lin = getattr(tm, name)
        np.testing.assert_allclose(lin.weight.grad.numpy(),
                                   np.asarray(p['kernel']).T, rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(p['bias']),
                                   rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize('name', ['nppnet', 'nppnet_top1'])
def test_nppnet_matches_reference_goldens(name):
    """The reference's own state_dicts load unchanged (the port's layer
    names map 1:1); tolerance of tests/test_mlp.py."""
    g = np.load(os.path.join(GOLDEN_DIR, f'{name}.npz'))
    ref = {'periodic_linears.%d' % i: 'periodic_%d' % i for i in range(8)}
    ref.update({'feature_linear1': 'feature1', 'feature_linear2': 'feature2',
                'scale_linears.0': 'scale_0', 'pos_linears.0': 'pos_0',
                'rgb_linear': 'rgb'})
    model = NPPNet(462, 924, depth=8, width=64) if name == 'nppnet' \
        else NPPNetTop1(462, depth=8, width=64)
    wanted = model.state_dict().keys()
    sd = {}
    for k in g.files:
        if k.startswith('sd_'):
            mod, leaf = k[3:].rsplit('.', 1)
            key = f'{ref.get(mod)}.{leaf}'
            if key in wanted:
                sd[key] = _t(g[k])
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model(_t(g['x'])).numpy()
    np.testing.assert_allclose(out, g['y'], rtol=1e-4, atol=1e-5)


def test_nn_linear_init_matches_torchlinear_bounds():
    model = NPPNet(462, 924, depth=8, width=512)
    for name, mod in model.named_children():
        mod = mod.requires_grad_(False)
        bound = 1.0 / np.sqrt(mod.in_features)
        assert float(mod.weight.abs().max()) <= bound + 1e-7, name
        assert float(mod.bias.abs().max()) <= bound + 1e-7, name


def test_config_fields_and_defaults_match_jax():
    from npp_tpu import config as JC
    for cls in ('BaseConfig', 'FitConfig', 'CompletionConfig', 'SearchConfig',
                'SegmentationConfig', 'RemappingConfig'):
        jf = {f.name: f.default for f in dataclasses.fields(getattr(JC, cls))}
        tf = {f.name: f.default for f in dataclasses.fields(getattr(TC, cls))}
        assert jf == tf, cls


def _port_sources():
    pkg = os.path.join(ROOT, 'npp_tpu_torch')
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)
    scripts = os.path.join(ROOT, 'scripts')
    for f in sorted(os.listdir(scripts)):
        if f.startswith('torch_') and f.endswith('.py'):
            yield os.path.join(scripts, f)
    yield os.path.join(ROOT, 'chip_smoke.py')


def test_port_imports_no_jax_and_nothing_of_npp_tpu():
    """Nothing of JAX or npp_tpu anywhere; neither sklearn nor skimage,
    which the card's machine lacks; cv2 (also absent there) only inside
    the functions that read and write PNGs, never when a module is
    imported."""
    banned = ('jax', 'jaxlib', 'flax', 'optax', 'npp_tpu', 'sklearn',
              'skimage')
    banned_at_import = ('cv2',)
    n = 0
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        top = {id(node) for node in tree.body}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            for name in names:
                root = name.split('.')[0]
                assert root not in banned, (path, name)
                assert not (id(node) in top and root in banned_at_import), \
                    (path, name)
        n += 1
    assert n > 20


def test_entry_points_raise_without_a_card(monkeypatch):
    from npp_tpu_torch.device import resolve_device
    from npp_tpu_torch.models.completion import run_completion
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device()
    with pytest.raises(RuntimeError, match='CUDA'):
        run_completion(TC.CompletionConfig(), save=False)
    assert resolve_device('cpu').type == 'cpu'


def test_unported_options_raise():
    """Nothing of npp_tpu's one-card options is left unported: the option
    gate (check_slice) is gone, LPIPS builds all three of npp_tpu's nets
    (squeeze since the seam slice), and an unknown net raises as in
    npp_tpu."""
    import npp_tpu_torch.models.pipeline as pipeline
    from npp_tpu_torch.losses.lpips import LPIPS
    assert not hasattr(pipeline, 'check_slice')
    cpu = torch.device('cpu')
    assert LPIPS(cpu, net='alex').chns == (64, 192, 384, 256, 256)
    assert LPIPS(cpu, net='squeeze').chns == (64, 128, 256, 384, 384, 512,
                                              512)
    with pytest.raises(ValueError, match='unsupported LPIPS net'):
        LPIPS(cpu, net='resnet')
