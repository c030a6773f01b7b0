"""The kind 'stacked_mlp_regression', which is not a fit: M two-layer tanh
MLPs stacked in batched products, each fitted to its own regression
targets by full-batch Adam, `block` steps a block, in float32. Its plain
reference is the same arithmetic, backward pass and Adam in float64 NumPy.
Everything a kind provides (programs/__init__.py) is here."""
import contextlib
import json
import os
from types import SimpleNamespace

import numpy as np

NUMBERS = ('loss_gap', 'change_gap')
LEAVES = ('w1', 'b1', 'w2', 'b2')
BETAS, EPS = (0.9, 0.999), 1e-8


def make_inputs(config, traffic, seed, device):
    rng = np.random.RandomState(int(seed) % (2 ** 32))
    m, f, h, r = (config[k] for k in ('models', 'features', 'width', 'rows'))
    x = rng.randn(m, r, f)
    y = np.tanh(x @ rng.randn(m, f, 1)) + 0.1 * rng.randn(m, r, 1)
    params = {'w1': rng.randn(m, f, h) / np.sqrt(f),
              'b1': np.zeros((m, 1, h)),
              'w2': rng.randn(m, h, 1) / np.sqrt(h),
              'b2': np.zeros((m, 1, 1))}
    return SimpleNamespace(x=x, y=y, params=params)


@contextlib.contextmanager
def staged(inputs, directory):
    yield      # the program reads nothing from disk


def build(config, traffic, inputs, device):
    import torch
    f32 = dict(dtype=torch.float32, device=device)
    p = {k: torch.tensor(v, **f32).requires_grad_()
         for k, v in inputs.params.items()}
    x, y = torch.tensor(inputs.x, **f32), torch.tensor(inputs.y, **f32)
    state = SimpleNamespace(params=p, on_step=None, opt=torch.optim.Adam(
        [p[k] for k in LEAVES], lr=config['lr'], betas=BETAS, eps=EPS))
    block = int(traffic['block'])

    def run_block(st, feed):
        for _ in range(block):
            st.opt.zero_grad(set_to_none=True)
            hid = torch.tanh(torch.bmm(x, p['w1']) + p['b1'])
            pred = torch.bmm(hid, p['w2']) + p['b2']
            loss = ((pred - y) ** 2).mean(dim=(1, 2)).sum()
            loss.backward()
            st.opt.step()
            if st.on_step is not None:
                st.on_step(loss.detach())
        return {'loss': loss.detach()}

    return SimpleNamespace(run_block=run_block, state=state, feed=None,
                           images=config['models'], block=block, table=None)


def _host(params):
    return {k: v.detach().double().cpu().numpy().copy()
            for k, v in params.items()}


def first_block(fit, config, traffic, device):
    start, losses = _host(fit.state.params), []
    fit.state.on_step = losses.append
    fit.run_block(fit.state, fit.feed)
    fit.state.on_step = None
    return {'losses': [float(v) for v in losses], 'start': start,
            'after': _host(fit.state.params)}


def reference(inputs, config, steps, dtype=np.float64):
    """(each step's loss, the parameters after `steps` steps)."""
    p = {k: v.astype(dtype) for k, v in inputs.params.items()}
    x, y = inputs.x.astype(dtype), inputs.y.astype(dtype)
    m1 = {k: np.zeros_like(v) for k, v in p.items()}
    m2 = {k: np.zeros_like(v) for k, v in p.items()}
    losses = []
    for t in range(1, steps + 1):
        hid = np.tanh(x @ p['w1'] + p['b1'])
        d = hid @ p['w2'] + p['b2'] - y
        losses.append(float((d ** 2).mean(axis=(1, 2)).sum()))
        g_pred = 2.0 * d / (d.shape[1] * d.shape[2])
        g_a = (g_pred @ p['w2'].transpose(0, 2, 1)) * (1.0 - hid ** 2)
        g = {'w2': hid.transpose(0, 2, 1) @ g_pred,
             'b2': g_pred.sum(1, keepdims=True),
             'w1': x.transpose(0, 2, 1) @ g_a,
             'b1': g_a.sum(1, keepdims=True)}
        for k in LEAVES:
            m1[k] = BETAS[0] * m1[k] + (1 - BETAS[0]) * g[k]
            m2[k] = BETAS[1] * m2[k] + (1 - BETAS[1]) * g[k] * g[k]
            denom = np.sqrt(m2[k]) / np.sqrt(1 - BETAS[1] ** t) + EPS
            p[k] = p[k] - config['lr'] / (1 - BETAS[0] ** t) * m1[k] / denom
    return losses, p


def _numbers(losses, after, start, ref_losses, ref_after):
    def change(q):
        return {k: float(np.linalg.norm(q[k] - start[k])) for k in LEAVES}
    cp, cr = change(after), change(ref_after)
    med = float(np.median(list(cr.values())))
    return {'loss_gap': max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_losses)),
            'change_gap': max(abs(cp[k] - cr[k]) / max(cr[k], med)
                              for k in LEAVES)}


def check(config, traffic, inputs, record, device):
    ref_losses, ref_after = reference(inputs, config, len(record['losses']))
    numbers = _numbers(record['losses'], record['after'], record['start'],
                       ref_losses, ref_after)
    return numbers, {'program_losses': record['losses'],
                     'reference_losses': ref_losses}


def limits(bench_dir, cell):
    with open(os.path.join(bench_dir, 'limits', f'{cell}.json')) as f:
        out = json.load(f)['limits']
    unknown = sorted(set(out) - set(NUMBERS))
    if unknown:
        raise KeyError(f'limits/{cell}.json: unknown {unknown}')
    return {k: float(v) for k, v in out.items()}


def work(config, traffic):
    m, f, h, r = (config[k] for k in ('models', 'features', 'width', 'rows'))
    items = [{'n': m, 'rows': r, 'in': f, 'out': h},
             {'n': m, 'rows': r, 'in': h, 'out': 1}]
    mlp = sum(3 * 2.0 * r * it['in'] * it['out'] for it in items)
    return {'flops': {'mlp': mlp, 'total': mlp}, 'peak': 'f32',
            'kernels': {'bmm': items}}


def calibrate(cell, config, traffic, seed, device):
    """The program's numbers and the control's: the reference in float16
    put in the program's place."""
    from npp_bench import harness
    inputs = make_inputs(config, traffic, seed, device)
    fit, record, _ = harness.first_block(
        harness.kind(traffic['entry']), config, traffic, inputs, device)
    ref = reference(inputs, config, fit.block)
    ctl_losses, ctl_after = reference(inputs, config, fit.block, np.float16)
    return {'cell': cell, 'seed': seed,
            'program': check(config, traffic, inputs, record, device)[0],
            'control_f16': _numbers(
                ctl_losses, {k: v.astype(np.float64)
                             for k, v in ctl_after.items()},
                inputs.params, *ref)}
