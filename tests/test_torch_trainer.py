"""Port parity on the CPU for the fit engine: one fit step with every loss
on against `npp_tpu`'s on the same parameters and batch, the Adam and
learning-rate conventions, and the 100-step trajectory of
tests/test_pipeline_parity.py against the reference's goldens."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from torch import nn

from npp_tpu.config import CompletionConfig as JaxCompletionConfig
from npp_tpu.config import replace as jax_replace
from npp_tpu.models import pipeline as JP
from npp_tpu.models import sampler as JS
from npp_tpu.models import trainer as JT
from npp_tpu.models.completion import COMPLETION_TASK
from npp_tpu.models.loaders import TaskData as JaxTaskData
from npp_tpu.nn import embedder as JE
from npp_tpu_torch import config as TC
from npp_tpu_torch.losses.pixel import img2mse
from npp_tpu_torch.losses.robust import adaptive_init
from npp_tpu_torch.models import pipeline as TP
from npp_tpu_torch.models import sampler as TS
from npp_tpu_torch.models import trainer as TT
from npp_tpu_torch.models.loaders import TaskData
from npp_tpu_torch.models.remapping import REMAPPING_TASK
from npp_tpu_torch.nn.embedder import TaskEmbedder, make_embedding_table
from npp_tpu_torch.nn.mlp import NPPNet
from npp_tpu_torch.utils.convert import params_from_jax
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

CPU = torch.device('cpu')
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), 'goldens')
TINY = dict(netwidth=32, netdepth=6, N_rand=64, patch_num=1,
            num_real_patch_per_sample=2)


def _tiny_arrays(h=40, w=48):
    """tests/test_trainer.py::tiny_data's example."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * yy / 10.0),
                    0.5 + 0.4 * np.cos(2 * np.pi * xx / 12.0),
                    0.5 * np.ones_like(yy)], -1)
    mask = np.ones((h, w, 1))
    mask[15:22, 18:28] = 0
    valid = np.ones((h, w, 1))
    return dict(img=img, masked_img=img * mask, mask=mask, valid_mask=valid,
                i_train=np.stack(np.nonzero(mask[..., 0]), 1),
                i_val=np.stack(np.nonzero(1 - mask[..., 0]), 1),
                selected_shifts=[[[12.0, 0.0], [0.0, 10.0]]] * 3,
                selected_angles=[[90.0, 180.0]] * 3,
                selected_periods=[[10.0, 12.0]] * 3, patch_size=16)


def _assert_scaled(got, want, rtol, what):
    """|got - want| <= rtol * max|want| over the whole tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err,
                                                          np.abs(want).max())


def test_fit_step_loss_and_grads_match_jax(monkeypatch):
    """One step with the pixel, CX and LPIPS-robust terms all on (a 'same'
    batch): the same MLP, latents, Fourier bands, pixel indices and
    PatchBatch on both sides.
    The JAX sampler is patched to return the fixed batch; the port gets it
    injected. f32 on both sides with native convolutions (see
    tests/test_torch_losses.py::native_conv): loss rtol 1e-4; gradients
    within 2e-3 of each tensor's largest magnitude (the CX softmax
    amplifies convolution reassociation)."""
    _fit_step_parity(monkeypatch, None)


def test_bf16_table_fit_step_matches_jax(monkeypatch):
    """The same step through each package's bfloat16 canvas table
    (embed_table='bfloat16'), at the same tolerances. The parent commit of
    this test failed it: its port built that table in float32 whatever the
    dtype, so its step computed another function than npp_tpu's."""
    _fit_step_parity(monkeypatch, 'bfloat16')


def test_bf16_feature_towers_fit_step_track_jax(monkeypatch):
    """feature_dtype='bfloat16': the LPIPS tower in bf16 activations (CX
    stays f32) in both packages. bf16 rounding differs between XLA's and
    PyTorch's convolutions, so the port's bf16 step is held to JAX's own
    bf16 step within twice the distance between JAX's bf16 and f32 steps:
    the loss, and the MLP gradient (the L2 norm of the difference over all
    its tensors). The loss's bound adds the distance between the two
    packages' f32 losses, which the bf16 step inherits: at this step JAX's
    bf16 loss equals its f32 loss to the last bit (the LPIPS-robust term
    is dominated by its latents' constant), so 2 x 0 alone would demand
    bit equality. The 2x bound alone would also pass f32 towers (they lie
    about 1x the gap from JAX's bf16 gradient), so the port's bf16
    gradient must also lie nearer JAX's bf16 gradient than JAX's f32 one,
    and the towers build_components makes must carry bf16 activations
    (LPIPS, and style for the remapping) with CX in f32."""
    tdata = TaskData(**_tiny_arrays())
    comps = TP.build_components(TC.replace(
        TC.CompletionConfig(), feature_dtype='bfloat16', **TINY), tdata, CPU)
    remap = TP.build_components(
        TC.replace(TC.RemappingConfig(), feature_dtype='bfloat16', **TINY),
        tdata, CPU, REMAPPING_TASK)
    x = torch.rand(1, 3, 16, 16)
    assert comps.percep.tower(x, comps.percep.taps)[
        comps.percep.taps[0]].dtype == torch.bfloat16
    assert remap.style.tower.dtype == torch.bfloat16
    assert comps.contextual.tower.dtype == torch.float32
    jl32, jg32, _, tl32, _, _ = _step_both(monkeypatch, None, 'float32')
    jl16, jg16, _, tl16, _, tst16 = _step_both(monkeypatch, None,
                                               'bfloat16')
    assert abs(float(tl16) - float(jl16)) <= \
        2 * abs(float(jl16) - float(jl32)) + abs(float(tl32) - float(jl32))

    def flat_jax(jg):
        return np.concatenate([np.concatenate(
            [np.asarray(p['kernel']).ravel(), np.asarray(p['bias']).ravel()])
            for _, p in sorted(jg['mlp'].items())])

    def flat_port(st, jg):
        return np.concatenate([np.concatenate(
            [getattr(st.params.mlp, n).weight.grad.numpy().T.ravel(),
             getattr(st.params.mlp, n).bias.grad.numpy().ravel()])
            for n, _ in sorted(jg['mlp'].items())])
    j32, j16 = flat_jax(jg32), flat_jax(jg16)
    bf16_shift = np.linalg.norm(j16 - j32)
    assert bf16_shift > 0
    port16 = flat_port(tst16, jg16)
    assert np.linalg.norm(port16 - j16) <= 2 * bf16_shift
    assert np.linalg.norm(port16 - j16) < np.linalg.norm(port16 - j32)


def _step_both(monkeypatch, table, feature_dtype='float32'):
    """One injected 'same' step of the tiny completion through both
    packages. table: None for the trig chain, or the dtype name of the
    canvas table both embed through; feature_dtype as the config's.
    Returns (JAX loss, JAX grads, JAX metrics, port loss, port metrics,
    port state) after the port's backward."""
    cfg = jax_replace(JaxCompletionConfig(), matmul_precision='float32',
                      feature_dtype=feature_dtype, **TINY)
    arrays = _tiny_arrays()
    jdata = JaxTaskData(**arrays)
    comps = JP.build_components(cfg, jdata, COMPLETION_TASK)
    state, _ = JT.init_fit_state(cfg, COMPLETION_TASK, comps.model,
                                 comps.embedder, jax.random.PRNGKey(0),
                                 comps.percep, comps.style)
    consts = JP.make_fit_consts(cfg, COMPLETION_TASK, jdata, 16)
    for i in range(100):
        batch = JS.sample_patches(jax.random.PRNGKey(i), consts.sampler, 1,
                                  16, 2, cfg.invalid_ratio)
        if int(batch.source) == JS.SOURCE_SAME:
            break
    monkeypatch.setattr(JT, 'sample_patches', lambda *a, **k: batch)
    jloss_fn = JT.build_loss_fn(cfg, COMPLETION_TASK, comps.model,
                                comps.percep, comps.contextual, comps.style,
                                1, 16)
    key = jax.random.PRNGKey(7)
    jemb = comps.embedder if table is None else \
        JE.make_embedding_table(comps.embedder, jnp.dtype(table))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, jemb, consts, key), has_aux=True))(
        state.params)
    pix_idx = jax.random.randint(jax.random.split(key)[0], (cfg.N_rand,), 0,
                                 consts.pool_train_n)

    tcfg = TC.replace(TC.CompletionConfig(), feature_dtype=feature_dtype,
                      **TINY)
    tdata = TaskData(**arrays)
    tcomps = TP.build_components(tcfg, tdata, CPU)
    tstate = TT.init_fit_state(tcfg, tcomps.model, tcomps.percep, CPU)
    npy = jax.tree.map(np.asarray, state.params)
    conv = params_from_jax({
        'mlp': npy['mlp'], 'adaptive_pix': npy['adaptive_pix'],
        'adaptive_percep': npy['adaptive_percep'],
        'embedder': {'freq_bands': np.asarray(comps.embedder.freq_bands)}})
    tstate.params.mlp.load_state_dict(conv['mlp'])
    tstate.params.adaptive_pix.load_state_dict(conv['adaptive_pix'])
    tstate.params.adaptive_percep.load_state_dict(conv['adaptive_percep'])
    tcomps.embedder.freq_bands = conv['embedder']['freq_bands']
    temb = tcomps.embedder if table is None else \
        make_embedding_table(tcomps.embedder, getattr(torch, table))
    tbatch = TS.PatchBatch(*[torch.as_tensor(np.asarray(v)) for v in
                             batch[:-1]], int(batch.source))
    tbatch.fake_coords = tbatch.fake_coords.long()
    tloss_fn = TT.build_loss_fn(tcfg, tcomps.percep, tcomps.contextual, 1, 16,
                                inject=(torch.as_tensor(np.asarray(pix_idx)
                                                        ).long(), tbatch))
    with torch.backends.mkldnn.flags(enabled=False):
        loss, metrics = tloss_fn(tstate.params, temb,
                                 TP.make_fit_consts(tcfg, tdata, 16, CPU),
                                 None)
        loss.backward()
    return jl, jg, jm, loss.detach(), metrics, tstate


def _fit_step_parity(monkeypatch, table):
    """One injected step through both packages; table: None for the trig
    chain, or the dtype name of the canvas table both embed through."""
    jl, jg, jm, loss, metrics, tstate = _step_both(monkeypatch, table)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for k in ('pixel', 'contextual', 'perceptual'):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert float(jm['perceptual']) > 0
    for name, p in jg['mlp'].items():
        lin = getattr(tstate.params.mlp, name)
        _assert_scaled(lin.weight.grad.numpy().T, p['kernel'], 2e-3, name)
        _assert_scaled(lin.bias.grad.numpy(), p['bias'], 2e-3, name)
    pairs = [(tstate.params.adaptive_pix, jg['adaptive_pix'])]
    pairs += list(zip(tstate.params.adaptive_percep, jg['adaptive_percep']))
    for tp, jp in pairs:
        for f in ('latent_alpha', 'latent_scale'):
            got = getattr(tp, f).grad
            got = np.zeros(getattr(jp, f).shape) if got is None else got
            _assert_scaled(got, getattr(jp, f), 2e-3, f)


def test_schedule_matches_jax():
    jcfg, tcfg = JaxCompletionConfig(), TC.CompletionConfig()
    for k in (0, 1, 10, 2000, 49999):
        np.testing.assert_allclose(TT.make_schedule(tcfg)(k),
                                   float(JT.make_schedule(jcfg)(k)),
                                   rtol=1e-6)


class _TwoParams(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Parameter(torch.tensor([0.5, -1.0, 2.0]))
        self.b = nn.Parameter(torch.tensor([1.0, 1.0]))


def test_adam_moves_unreached_params_like_optax():
    """A parameter the loss reaches only on the first step (the LPIPS
    latents outside 'same' steps) keeps moving by momentum afterwards,
    as optax.adam moves it on zero gradients; torch.optim.Adam would skip
    it if its .grad were None. Same schedule convention: step k uses
    schedule(k). The two Adams round their update differently: rtol 1e-5."""
    sched = lambda k: 0.1 * 0.5 ** k  # noqa: E731
    p = _TwoParams()
    state = TT.FitState(p, torch.optim.Adam(p.parameters(), lr=1.0))

    def loss_fn(params, *_):
        loss = torch.sum(params.b ** 2)
        if state.step == 0:
            loss = loss + torch.sum(params.a * torch.tensor([1.0, -2.0, 3.0]))
        return loss, {}

    tx = optax.adam(lambda c: 0.1 * 0.5 ** c, b1=0.9, b2=0.999, eps=1e-8)
    jp = {'a': jnp.asarray([0.5, -1.0, 2.0]), 'b': jnp.asarray([1.0, 1.0])}
    opt = tx.init(jp)
    for step in range(4):
        TT.fit_step(state, loss_fn, None, None, None, sched)
        grads = {'a': jnp.asarray([1.0, -2.0, 3.0]) * (step == 0),
                 'b': 2 * jp['b']}
        upd, opt = tx.update(grads, opt, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(p.a.detach().numpy(), np.asarray(jp['a']),
                                   rtol=1e-5)
        np.testing.assert_allclose(p.b.detach().numpy(), np.asarray(jp['b']),
                                   rtol=1e-5)
    assert state.step == 4


def test_fit_trajectory_matches_reference_goldens():
    """tests/test_pipeline_parity.py::test_fit_trajectory_matches_reference
    on the port: a 100-iteration pixel-only fit from the reference's init,
    batches and learning-rate schedule, with the same tolerances (f32
    reassociation drift over 100 steps: rtol 2e-4 for the first 10 losses,
    5e-3 for all; final predictions within 2e-2, 3e-3 on average)."""
    g = np.load(os.path.join(GOLDEN_DIR, 'pipeline_fit.npz'))
    res = tuple(int(v) for v in g['res'])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    embedder = TaskEmbedder(
        freq_bands=t(g['freq_bands']), angles=t(g['angles']),
        periods=t(g['periods']), res=res, freq_scales=(1.0,),
        freq_offsets=(0.0, -1.0, 1.0, 0.5, -0.5), angle_offsets=(0.0,),
        out_dim=3 * 22 * 21, top1_dim=22 * 21)
    model = NPPNet(22 * 21, 2 * 22 * 21, depth=8, width=128)
    names = {f'periodic_linears.{i}': f'periodic_{i}' for i in range(8)}
    names.update({'feature_linear1': 'feature1', 'feature_linear2': 'feature2',
                  'scale_linears.0': 'scale_0', 'pos_linears.0': 'pos_0',
                  'rgb_linear': 'rgb'})
    model.load_state_dict({f'{ours}.{leaf}': t(g[f'sd_{ref}.{leaf}'])
                           for ref, ours in names.items()
                           for leaf in ('weight', 'bias')})
    lat = adaptive_init(3)
    lat.load_state_dict({'latent_alpha': t(g['lat_latent_alpha']),
                         'latent_scale': t(g['lat_latent_scale'])})
    params = TT.FitParams(model, lat)
    state = TT.FitState(params, torch.optim.Adam(params.parameters(),
                                                 betas=(0.9, 0.999),
                                                 eps=1e-8))
    i_train = np.asarray(g['i_train'])
    train_emb = embedder.embed(t(i_train))
    gt = t(g['img'][i_train[:, 0], i_train[:, 1]])
    idx_seq = torch.as_tensor(np.asarray(g['idx_seq'])).long()

    def loss_fn(p, *_):
        sel = idx_seq[state.step]
        pred = torch.sigmoid(p.mlp(train_emb[sel]))
        return img2mse(pred, gt[sel], 'robust_loss_adaptive', p.adaptive_pix,
                       torch.ones_like(pred[:, :1])), {}

    # the reference's schedule (train.py:256-264): step t uses
    # lrate * 0.1 ** (max(t-1, 0) / (lrate_decay*100))
    def sched(k):
        return 5e-4 * 0.1 ** (max(k - 1, 0) / (500 * 100.0))

    losses = np.asarray([
        float(TT.fit_step(state, loss_fn, embedder, None, None,
                          sched)['loss']) for _ in range(idx_seq.shape[0])])
    ref_losses = np.asarray(g['losses'])
    np.testing.assert_allclose(losses[:10], ref_losses[:10], rtol=2e-4)
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-3)

    with torch.no_grad():
        final_val = torch.sigmoid(model(embedder.embed(
            t(np.asarray(g['i_val'])[:512])))).numpy()
        final_train = torch.sigmoid(model(train_emb[:512])).numpy()
    assert np.abs(final_val - g['final_val']).max() < 2e-2
    assert np.abs(final_train - g['final_train']).max() < 2e-2
    assert np.abs(final_val - g['final_val']).mean() < 3e-3
