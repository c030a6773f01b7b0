"""The multi-image batched fit on the CPU (npp_tpu_torch/parallel/), as
tests/test_parallel.py holds npp_tpu's: the batched step against each
image's single-image port step and against npp_tpu's batched step on an
injected batch, fit_images against sequential fit_image (also across
patch decays and with gcd below 8), the bucket canvas, the table, the
warp override, segmentation and remapping steps, the milestone hook, and
K1's batched plain version.

Tolerances: one batched step equals the single steps to 1e-5 of each
gradient's largest value (stacked products reassociate); npp_tpu's step
as tests/test_torch_trainer.py holds it (loss 1e-4 relative, gradients
2e-3 of their largest value); fit_images equals fit_image at rtol 5e-4,
atol 5e-5 (1e-3 / 1e-4 across decays), as test_parallel.py holds
npp_tpu's runner."""
import jax
import numpy as np
import pytest
import torch

from npp_tpu_torch import config as TC
from npp_tpu_torch.kernels.periodic_embed import (periodic_embed,
                                                  periodic_embed_batched)
from npp_tpu_torch.models import pipeline as TP
from npp_tpu_torch.models import sampler as TS
from npp_tpu_torch.models import trainer as TT
from npp_tpu_torch.models.loaders import TaskData
from npp_tpu_torch.models.remapping import REMAPPING_TASK
from npp_tpu_torch.models.segmentation import SEGMENTATION_TASK
from npp_tpu_torch.nn.embedder import make_task_embedder
from npp_tpu_torch.parallel import batch as PB
from npp_tpu_torch.parallel.runner import fit_images, pad_to_canvas
from tests.test_torch_trainer import TINY, _assert_scaled, _tiny_arrays
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

CPU = torch.device('cpu')
PLAIN = dict(netwidth=32, netdepth=2, N_rand=32, patch_num=1,
             num_real_patch_per_sample=2, use_perceptual_loss=False,
             use_contextual_loss=False, matmul_precision='float32')


def _data(h=40, w=48, seed=0, **kw):
    """tests/test_torch_trainer.py's tiny example; seed > 0 shifts its
    content and lattice so two images differ."""
    a = _tiny_arrays(h, w)
    if seed:
        a['img'] = np.roll(a['img'], seed, axis=1)[..., ::-1].copy()
        a['masked_img'] = a['img'] * a['mask']
        a['selected_periods'] = [[10.0 + seed, 12.0]] * 3
    a['extra'] = {'clear_mask': a['mask'] * a['valid_mask']}
    a.update(kw)
    return TaskData(**a)


def _batch_of(source, consts, cfg, seed=0):
    """A patch batch of the given source drawn from the sampler ('same':
    LPIPS on; 'val': the comp-paste)."""
    for i in range(200):
        b = TS.sample_patches(torch.Generator().manual_seed(seed + i), consts,
                              cfg.patch_num, 16, cfg.num_real_patch_per_sample,
                              cfg.invalid_ratio)
        if b.source == source:
            return b
    raise AssertionError(f'no batch of source {source}')


def _batched_vs_single(cfg, datas, task, sources=None):
    """One injected batched step and each image's single-image step, from
    the same init: returns (batched loss, [single losses], batched state,
    [single states]) after both backward passes."""
    canvas = datas[0].img.shape[:2]
    comps = TP.build_components(cfg, datas[0], CPU, task)
    state0 = TT.init_fit_state(cfg, comps.model, comps.percep, CPU,
                               comps.style)
    embs = [make_task_embedder(cfg, np.asarray(d.selected_angles),
                               np.asarray(d.selected_periods),
                               d.img.shape[:2],
                               torch.Generator().manual_seed(cfg.seed), CPU)
            for d in datas]
    padded = [pad_to_canvas(d, *canvas) for d in datas]
    consts = [TP.make_fit_consts(cfg, d, 16, CPU, task) for d in padded]
    gen = torch.Generator().manual_seed(5)
    inject = []
    sources = sources or [TS.SOURCE_SAME] * len(datas)
    for j, c in enumerate(consts):
        b = _batch_of(sources[j], c.sampler, cfg, 10 * j)
        inject.append((torch.randint(0, c.pool_train_n, (cfg.N_rand,),
                                     generator=gen), b))
    state_b = PB.init_batched_state(cfg, state0, len(datas))
    emb_b = PB.stack_embedders(embs)
    loss_fn = PB.build_batched_loss_fn(
        cfg, comps.percep, comps.contextual, cfg.patch_num, 16, comps.style,
        task, inject=([p for p, _ in inject], [b for _, b in inject]),
        res=emb_b.res)
    loss_b, metrics_b = loss_fn(state_b.params, emb_b,
                                PB.stack_consts(consts), None)
    loss_b.backward()
    singles, losses = [], []
    for j, (emb, c) in enumerate(zip(embs, consts)):
        st = TT.init_fit_state(cfg, TP.build_components(cfg, datas[0], CPU,
                                                        task).model,
                               comps.percep, CPU, comps.style)
        fn = TT.build_loss_fn(cfg, comps.percep, comps.contextual,
                              cfg.patch_num, 16, inject=inject[j],
                              style=comps.style, task=task)
        loss, _ = fn(st.params, emb, c, None)
        loss.backward()
        singles.append(st)
        losses.append(float(loss.detach()))
    return float(loss_b), losses, state_b, singles, metrics_b


def _assert_grads_equal(state_b, singles, rtol):
    for j, st in enumerate(singles):
        for sp, tp, tr in PB._param_pairs(state_b.params, st.params):
            g = PB._piece(sp.grad, j, tr)
            # a single step leaves a latent its loss did not reach at None
            want = torch.zeros_like(tp) if tp.grad is None else tp.grad
            _assert_scaled(g.numpy(), want.numpy(), rtol, tuple(tp.shape))


@pytest.mark.parametrize('task', ['completion', 'segmentation', 'remapping'])
def test_batched_step_equals_single_steps(task):
    """Two images of different canvases (the second padded into the
    first's), every loss of the task on: the batched loss is the sum of
    the single losses and each image's gradient is its single step's."""
    spec, cls = {'completion': (TT.COMPLETION_TASK, TC.CompletionConfig),
                 'segmentation': (SEGMENTATION_TASK, TC.SegmentationConfig),
                 'remapping': (REMAPPING_TASK, TC.RemappingConfig)}[task]
    kw = dict(TINY, matmul_precision='float32')
    if task == 'remapping':
        kw.update(use_style_loss=True, use_adaptive_style_loss=True)
    cfg = TC.replace(cls(), **kw)
    loss_b, losses, state_b, singles, metrics = _batched_vs_single(
        cfg, [_data(), _data(36, 44, seed=3)], spec)
    np.testing.assert_allclose(loss_b, sum(losses), rtol=1e-5)
    assert float(metrics['source']) == TS.SOURCE_SAME
    _assert_grads_equal(state_b, singles, 1e-5)


def test_batched_step_per_image_sources():
    """One image on a 'same' batch and one on a 'val' batch: LPIPS runs
    on the first only, the comp-paste on the second only."""
    cfg = TC.replace(TC.CompletionConfig(), matmul_precision='float32',
                     **TINY)
    loss_b, losses, state_b, singles, _ = _batched_vs_single(
        cfg, [_data(), _data(seed=2)], TT.COMPLETION_TASK,
        sources=[TS.SOURCE_SAME, TS.SOURCE_VAL])
    np.testing.assert_allclose(loss_b, sum(losses), rtol=1e-5)
    _assert_grads_equal(state_b, singles, 1e-5)


def test_batched_step_matches_npp_tpu(monkeypatch):
    """npp_tpu's make_batched_fit_step and the port's batched step from
    npp_tpu's init, on the same injected 'same' batch for both images and
    npp_tpu's pixel draws: the loss, and each image's gradient (Adam's
    first moment after one step is 0.1 g, in both packages)."""
    from npp_tpu.config import CompletionConfig as JaxConfig
    from npp_tpu.config import replace as jax_replace
    from npp_tpu.models import sampler as JS
    from npp_tpu.models import trainer as JT
    from npp_tpu.models.completion import COMPLETION_TASK as JTASK
    from npp_tpu.models.loaders import TaskData as JaxTaskData
    from npp_tpu.models.pipeline import build_components, make_fit_consts
    from npp_tpu.nn.embedder import make_task_embedder as jax_embedder
    from npp_tpu.parallel import batch as JB
    from npp_tpu.parallel.runner import _pad_pools_to_common
    from npp_tpu.parallel.runner import pad_to_canvas as jax_pad
    from npp_tpu_torch.utils.convert import params_from_jax

    jcfg = jax_replace(JaxConfig(), matmul_precision='float32', **TINY)
    arrays = [_tiny_arrays(), _tiny_arrays(36, 44)]
    jdatas = [JaxTaskData(**a) for a in arrays]
    dims = [d.img.shape[:2] for d in jdatas]
    jdatas = [jax_pad(d, 40, 48) for d in jdatas]
    jembs = [jax_embedder(jcfg, np.asarray(d.selected_angles),
                          np.asarray(d.selected_periods), dims[j],
                          jax.random.PRNGKey(jcfg.seed))
             for j, d in enumerate(jdatas)]
    comps = build_components(jcfg, jdatas[0], JTASK)
    state, tx = JB.init_batched_state(jcfg, JTASK, comps.model, jembs,
                                      jax.random.PRNGKey(0), comps.percep,
                                      None)
    consts = _pad_pools_to_common([make_fit_consts(jcfg, JTASK, d, 16)
                                   for d in jdatas])
    for i in range(100):
        batch = JS.sample_patches(jax.random.PRNGKey(i), consts[0].sampler, 1,
                                  16, 2, jcfg.invalid_ratio)
        if int(batch.source) == JS.SOURCE_SAME:
            break
    monkeypatch.setattr(JT, 'sample_patches', lambda *a, **k: batch)
    key = jax.random.PRNGKey(7)
    step = JB.make_batched_fit_step(jcfg, JTASK, comps.model, comps.percep,
                                    comps.contextual, None, tx, 1, 16)
    new_state, jm = step(state, JB.stack_embedders(jembs),
                         JB.stack_consts(consts), key)
    pix = [torch.tensor(np.asarray(jax.random.randint(
        jax.random.split(key)[0], (jcfg.N_rand,), 0, c.pool_train_n))).long()
        for c in consts]

    cfg = TC.replace(TC.CompletionConfig(), matmul_precision='float32',
                     **TINY)
    tdatas = [TaskData(**a) for a in arrays]
    tcomps = TP.build_components(cfg, tdatas[0], CPU)
    npy = jax.tree.map(np.asarray, state.params)
    singles = []
    for j in range(2):
        st = TT.init_fit_state(cfg, TP.build_components(cfg, tdatas[0],
                                                        CPU).model,
                               tcomps.percep, CPU)
        conv = params_from_jax(jax.tree.map(lambda x, jj=j: x[jj], {
            'mlp': npy['mlp'], 'adaptive_pix': npy['adaptive_pix'],
            'adaptive_percep': npy['adaptive_percep']}))
        st.params.mlp.load_state_dict(conv['mlp'])
        st.params.adaptive_pix.load_state_dict(conv['adaptive_pix'])
        st.params.adaptive_percep.load_state_dict(conv['adaptive_percep'])
        singles.append(st.params)
    params_b = PB.stack_modules(singles)
    opt = torch.optim.Adam(params_b.parameters(), lr=cfg.lrate)
    state_b = TT.FitState(params_b, opt, 0)
    bands = torch.as_tensor(np.asarray(jembs[0].freq_bands))
    embs = [make_task_embedder(cfg, np.asarray(d.selected_angles),
                               np.asarray(d.selected_periods), dims[j],
                               torch.Generator().manual_seed(0), CPU)
            for j, d in enumerate(tdatas)]
    for e in embs:
        e.freq_bands = bands
    tconsts = [TP.make_fit_consts(cfg, pad_to_canvas(d, 40, 48), 16, CPU)
               for d in tdatas]
    tbatch = TS.PatchBatch(*[torch.as_tensor(np.asarray(v)) for v in
                             batch[:-1]], int(batch.source))
    tbatch.fake_coords = tbatch.fake_coords.long()
    loss_fn = PB.build_batched_loss_fn(
        cfg, tcomps.percep, tcomps.contextual, 1, 16,
        inject=(pix, [tbatch, tbatch]), res=PB.stack_embedders(embs).res)
    with torch.backends.mkldnn.flags(enabled=False):
        metrics = TT.fit_step(state_b, loss_fn, PB.stack_embedders(embs),
                              PB.stack_consts(tconsts), None,
                              TT.make_schedule(cfg))
    np.testing.assert_allclose(float(metrics['loss']), 2 * float(jm['loss']),
                               rtol=1e-4)
    for k in ('pixel', 'contextual', 'perceptual'):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    mu = [s.mu for s in jax.tree.leaves(
        new_state.opt_state, is_leaf=lambda x: hasattr(x, 'mu'))
        if hasattr(s, 'mu')][0]
    jmu = jax.tree.map(np.asarray, mu)
    for j in range(2):
        for name, p in jmu['mlp'].items():
            lin = getattr(params_b.mlp, name)
            _assert_scaled(opt.state[lin.kernel]['exp_avg'][j].numpy(),
                           p['kernel'][j], 2e-3, name)
            _assert_scaled(opt.state[lin.bias]['exp_avg'][j].numpy(),
                           p['bias'][j], 2e-3, name)


def _params_close(a, b, rtol, atol):
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize('n_iters,i_testset,decay,h,w,patch', [
    (11, 10, 2000, 40, 48, 16),      # one block of 10, then a single step
    (8, 5, 2000, 40, 48, 16),        # gcd below 8: single steps
    (35, 10, 10, 96, 112, 64),       # two patch decays, 64 -> 32 -> 16
])
def test_fit_images_matches_sequential_fit_image(n_iters, i_testset, decay,
                                                 h, w, patch):
    cfg = TC.replace(TC.CompletionConfig(), N_iters=n_iters,
                     i_testset=i_testset, i_print=i_testset,
                     patch_size_decay=decay, **PLAIN)
    datas = [_data(h, w, patch_size=patch),
             _data(h, w, seed=2, patch_size=patch)]
    bat = fit_images(cfg, TT.COMPLETION_TASK, datas, canvas_multiple=16,
                     device='cpu')
    tol = (1e-3, 1e-4) if decay < n_iters else (5e-4, 5e-5)
    for d, b in zip(datas, bat):
        seq = TP.fit_image(cfg, d, log_every=cfg.i_print, device='cpu')
        assert b.step == seq.state.step == n_iters - 1
        _params_close(seq.state.params, b.params, *tol)


def test_fit_images_invariant_to_bucket_canvas():
    cfg = TC.replace(TC.CompletionConfig(), **PLAIN)
    d = _data()
    tight = fit_images(cfg, TT.COMPLETION_TASK, [d], n_iters=5,
                       canvas_multiple=8, device='cpu')[0]
    bucket = fit_images(cfg, TT.COMPLETION_TASK, [d], n_iters=5,
                        canvas_multiple=64, device='cpu')[0]
    _params_close(tight.params, bucket.params, 2e-4, 2e-5)


def test_fit_images_table_matches_off():
    """Per-image tables over the shared bucket canvas (each at its own
    tight normalisation) against K1 on the fly, two images of different
    sizes in one bucket; and the guard: a budget below the tables skips
    them."""
    base = dict(PLAIN, N_iters=11, i_testset=10, i_print=10)
    datas = [_data(), _data(36, 44, seed=2)]
    stats = {}
    on = fit_images(TC.replace(TC.CompletionConfig(), embed_table='float32',
                               **base), TT.COMPLETION_TASK, datas,
                    canvas_multiple=16, device='cpu', stats=stats)
    assert stats['buckets'][0]['table'] == 'float32'
    off = fit_images(TC.replace(TC.CompletionConfig(), embed_table='',
                                **base), TT.COMPLETION_TASK, datas,
                     canvas_multiple=16, device='cpu')
    for a, b in zip(on, off):
        _params_close(a.params, b.params, 5e-5, 5e-6)
    stats = {}
    fit_images(TC.replace(TC.CompletionConfig(), embed_table='float32',
                          embed_table_max_mb=1, **base), TT.COMPLETION_TASK,
               datas, n_iters=2, canvas_multiple=16, device='cpu',
               stats=stats)
    assert stats['buckets'][0]['table'] is None


def test_fit_images_warp_field_override():
    """per_image={'warp_field': True} puts the image in a bucket of its
    own with the stacked warp field; both images equal their sequential
    fits (the warped one with warp_field on)."""
    cfg = TC.replace(TC.CompletionConfig(), N_iters=9, i_testset=8,
                     i_print=8, **PLAIN)
    datas = [_data(), _data(seed=2)]
    bat = fit_images(cfg, TT.COMPLETION_TASK, datas,
                     per_image=[{'warp_field': True}, {}],
                     canvas_multiple=16, device='cpu')
    assert bat[0].params.warp is not None and bat[1].params.warp is None
    for d, b, warp in zip(datas, bat, (True, False)):
        seq = TP.fit_image(TC.replace(cfg, warp_field=warp), d,
                           log_every=cfg.i_print, device='cpu')
        _params_close(seq.state.params, b.params, 5e-4, 5e-5)


def test_fit_images_milestone_hook_matches_prefix_run():
    cfg = TC.replace(TC.CompletionConfig(), i_testset=4, i_print=2, **PLAIN)
    datas = [_data(), _data(36, 44, seed=2)]
    fired = []

    def hook(i, idxs, state):
        fired.append((i, list(idxs),
                      [PB.unstack_params(state.params, ctx_template, j)
                       for j in range(2)]))

    ctx_template = TT.init_fit_state(
        cfg, TP.build_components(cfg, datas[0], CPU).model, None, CPU).params
    fit_images(cfg, TT.COMPLETION_TASK, datas, n_iters=8, canvas_multiple=16,
               milestone_hook=hook, device='cpu')
    assert [f[0] for f in fired] == [4, 8] and fired[0][1] == [0, 1]
    prefix = fit_images(cfg, TT.COMPLETION_TASK, datas, n_iters=4,
                        canvas_multiple=16, device='cpu')
    for j in range(2):
        for (k, a), (_, b) in zip(
                fired[0][2][j].state_dict().items(),
                prefix[j].params.state_dict().items()):
            assert torch.equal(a, b), k


def test_unstacked_state_carries_adam_state():
    """A per-image FitState from fit_images carries the step count and an
    Adam state for every parameter (its slice of the stacked moments)."""
    cfg = TC.replace(TC.CompletionConfig(), N_iters=4, i_testset=3,
                     i_print=3, **PLAIN)
    states = fit_images(cfg, TT.COMPLETION_TASK, [_data()], device='cpu',
                        canvas_multiple=16)
    st = states[0]
    assert st.step == 3 and len(st.optimizer.state) == \
        len(list(st.params.parameters()))


def test_k1_batched_plain_matches_single_calls():
    """periodic_embed_batched's plain version against B single-image
    calls, each image with its own proposals and dims: equal bit for bit,
    in f32 and in bf16, and its coordinate gradient too."""
    g = torch.Generator().manual_seed(0)
    b, n, k = 3, 40, 3
    coords = (torch.rand(b, n, 2, generator=g) * 60).requires_grad_()
    ang = torch.rand(b, k, 2, generator=g) * 180
    per = torch.rand(b, k, 2, generator=g) * 20 + 5
    bands = torch.randn(10, generator=g) * 10
    res = torch.tensor([[64., 80.], [40., 48.], [32., 96.]])
    cfgs = ((1.0,), (0.0, 0.5), (0.0,))
    for dtype in (torch.float32, torch.bfloat16):
        out = periodic_embed_batched(coords, ang, per, bands, *cfgs, res,
                                     dtype)
        for j in range(b):
            one = periodic_embed(coords[j], ang[j], per[j], bands, *cfgs,
                                 (int(res[j, 0]), int(res[j, 1])), dtype)
            assert torch.equal(out[j], one)
    w = torch.randn(b, n, out.shape[-1], generator=g)
    (gb,) = torch.autograd.grad((periodic_embed_batched(
        coords, ang, per, bands, *cfgs, res) * w).sum(), coords)
    for j in range(b):
        c = coords[j].detach().requires_grad_()
        (g1,) = torch.autograd.grad((periodic_embed(
            c, ang[j], per[j], bands, *cfgs,
            (int(res[j, 0]), int(res[j, 1]))) * w[j]).sum(), c)
        torch.testing.assert_close(gb[j], g1, rtol=1e-6, atol=1e-6)
    table = PB.make_batched_table(PB.StackedEmbedder(
        bands, ang, per, res, *cfgs, out.shape[-1], out.shape[-1] // k),
        (8, 12))
    rows = torch.tensor([[[1., 2.], [7., 11.]]] * b)
    want = periodic_embed_batched(rows, ang, per, bands, *cfgs, res)
    assert torch.equal(table.embed(rows), want)
