"""The harness's yardstick and its discovery, on the CPU: the FLOP counts,
K2's and K3's least times against PERF.md's table of kernels, the
per-layer readers on a made-up profile, BENCHMARK.json's form, and a new
configuration, traffic mix and metric found by name in a copy. One test
runs a cell on the card (marker `cuda`; it skips without one)."""
import json
import os
import re
import shutil
import time

import pytest

from npp_bench import flops, harness
from npp_bench.trace import Summary, _union

BENCH = harness.BENCH
ROOT = harness.ROOT
H100 = flops.peaks('NVIDIA H100 80GB HBM3')
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def config(name):
    return harness.load_json(os.path.join(BENCH, 'configs', f'{name}.json'))


def _bench_torch_count(cfg):
    """bench_torch.py's convention, from the count step_mfu uses: it also
    counts the first layer's input gradient, a third pass of each tower
    on the predicted stack and two more CX products."""
    need = flops.flops_per_image_step(cfg)
    sh = flops.step_shapes(cfg)
    s, pk = sh['patch'], sh['pk']
    d_in, d_out = flops.mlp_layers(cfg['mlp'])[0]
    cx, lp = cfg['towers']['contextual'], cfg['towers']['perceptual']

    def tower(t):
        return pk * flops.conv_flops(flops.tower_convs(t['blocks'],
                                                       t['convs']), s)

    p = (s // cx['downsample']) ** 2
    out = {'mlp': need['mlp'] + 2.0 * sh['rows'] * d_in * d_out,
           'contextual': need['contextual'] + tower(cx) +
           2.0 * 2.0 * pk * cx['channels'] * p * p,
           'perceptual': need['perceptual'] + flops.SAME_PROB * tower(lp)}
    out['total'] = sum(out.values())
    return need, out


def test_flops_equal_bench_torch_count():
    """bench_torch.py's count of a completion step (PERF.md §5): 1,745.6
    GFLOP, MLP 1,365.0, CX 305.4, LPIPS 75.2."""
    _, f = _bench_torch_count(config('npp-completion'))
    assert f['total'] / 1e9 == pytest.approx(1745.6, abs=0.05)
    assert f['mlp'] / 1e9 == pytest.approx(1365.0, abs=0.05)
    assert f['contextual'] / 1e9 == pytest.approx(305.4, abs=0.05)
    assert f['perceptual'] / 1e9 == pytest.approx(75.2, abs=0.05)


def test_needed_work_count():
    """The count step_mfu uses: the frozen towers' input gradient only,
    CX's product twice, the first layer's input gradient left out."""
    need, conv = _bench_torch_count(config('npp-completion'))
    assert need['perceptual'] == pytest.approx(conv['perceptual'] * 3 / 4)
    assert need['total'] / 1e9 == pytest.approx(1614.46, abs=0.01)
    remap = flops.flops_per_image_step(config('npp-remapping'))
    assert remap['perceptual'] == 0 and remap['style'] > 0
    assert remap['total'] / 1e9 == pytest.approx(429.96, abs=0.01)


# PERF.md §6's bound column, ms: (rows, width, forward, backward)
K2_ROWS = [(59392, 512, 0.0726, 0.1089), (16384, 512, 0.0200, 0.0300),
           (3 * 59392, 512, 0.2179, 0.3268)]
# (N, P, C, forward, backward with dx and dy), the mask read forward
K3_ROWS = [(6, 1600, 256, 0.0159, 0.0318), (18, 1600, 256, 0.0477, 0.0953),
           (6, 256, 256, 9.4e-4, 0.0019)]


@pytest.mark.parametrize('rows,width,fwd,bwd', K2_ROWS)
def test_k2_bound_matches_perf_table(rows, width, fwd, bwd):
    f, b = flops.k2_bounds(rows, width, H100)
    assert f * 1e3 == pytest.approx(fwd, rel=2e-3, abs=5e-5)
    assert b * 1e3 == pytest.approx(bwd, rel=2e-3, abs=5e-5)


@pytest.mark.parametrize('n,p,c,fwd,bwd', K3_ROWS)
def test_k3_bound_matches_perf_table(n, p, c, fwd, bwd):
    f, b = flops.k3_bounds(n, p, p, c, H100, need_dx=True, need_dy=True,
                           mask=True)
    assert f * 1e3 == pytest.approx(fwd, rel=2e-2, abs=5e-5)
    assert b * 1e3 == pytest.approx(bwd, rel=2e-2, abs=5e-5)
    # the fits take no gradient in y: one backward product
    _, b1 = flops.k3_bounds(n, p, p, c, H100)
    assert b1 < b


def _summary(steps=2):
    """Two steps: a K2 forward and backward, a K3 product, a GEMM, idle
    gaps between them."""
    kernels = [('snake_fwd_kernel', 0.0, 100.0), ('snake_bwd_kernel', 150.0,
                                                  100.0),
               ('cx_gemm_tf32', 300.0, 200.0), ('nvjet_tst_gemm', 450.0,
                                                100.0)]
    busy = sum(b - a for a, b in _union([(s, s + d) for _, s, d in kernels]))
    return Summary(steps=steps, window_s=1e-3, busy_s=busy / 1e6,
                   kernels=kernels)


def _ctx(summary, rate=40.0):
    import types
    cfg = config('npp-completion')
    groups = dict(harness.load_json(os.path.join(
        BENCH, 'metrics', 'kernel_groups.json'))['groups'])
    return types.SimpleNamespace(
        summary=summary, rate=rate, step_s=1.0 / rate, config=cfg,
        images=1, shapes=flops.step_shapes(cfg), peaks=H100,
        flops=flops.flops_per_image_step(cfg), matmul_peak=H100['tf32'],
        group=lambda g: groups[g])


def test_readers_on_a_made_up_profile():
    s = _summary()
    ctx = _ctx(s)
    read = {n: harness.reader(n) for n in (
        'step_mfu', 'device_idle_share', 'launches_per_step', 'k2_roofline',
        'k3_roofline')}
    assert read['launches_per_step'](ctx) == 2.0
    assert read['step_mfu'](ctx) == pytest.approx(
        100 * 1614.46e9 * 40 / 495e12, rel=1e-4)
    # busy 450 us (the GEMM overlaps K3) in a traced window of 1 ms
    assert s.busy_s == pytest.approx(450e-6)
    assert read['device_idle_share'](ctx) == pytest.approx(100 * 0.55)
    k2_least = sum(sum(flops.k2_bounds(59392, w, H100))
                   for w in flops.snake_layers(ctx.config['mlp']))
    assert read['k2_roofline'](ctx) == pytest.approx(
        100 * k2_least * 2 / 200e-6)
    f, b = flops.k3_bounds(6, 1600, 1600, 256, H100)
    assert read['k3_roofline'](ctx) == pytest.approx(100 * (f + b) * 2
                                                     / 200e-6)
    # a reader with nothing to read returns nothing, never 0
    empty = _ctx(Summary(steps=2, window_s=1e-3, busy_s=0.0, kernels=[]))
    assert read['k3_roofline'](empty) is None
    assert read['k2_roofline'](empty) is None
    assert read['launches_per_step'](empty) is None


def test_benchmark_json_form():
    bench = harness.load_benchmark()
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert bench['command'] == ['python3', 'npp_bench/run.py']
    assert bench['paths'] == ['npp_bench']
    names = [c['name'] for c in bench['configs']] + \
        [w['name'] for w in bench['workloads']] + \
        [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    assert len(names) == len(set(names))
    for n in names + [w['traffic'] for w in bench['workloads']]:
        assert NAME.match(n), n
    e2e = {m['name'] for m in bench['end_to_end']}
    assert {'image_steps_per_s', 'peak_mem_gib', 'setup_s'} <= e2e
    for m in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for m in bench['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in bench['per_layer']:
        assert m['moves'] in e2e and m['source'] in (
            'device_trace', 'program_span', 'program_counter', 'host_clock')
        assert os.path.exists(os.path.join(BENCH, 'metrics',
                                           f'{m["name"]}.py'))
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'
    for c in bench['configs']:
        assert os.path.exists(os.path.join(ROOT, c['file']))
        assert c['file'].startswith('npp_bench/') and c['reduced'] == []
    for w in bench['workloads']:
        assert w['chips'] == 1 and len(w['why']) <= 200
        assert os.path.exists(os.path.join(BENCH, 'traffic',
                                           f'{w["traffic"]}.json'))
        assert os.path.exists(os.path.join(BENCH, 'limits',
                                           f'{w["name"]}.json'))
    assert 1 <= bench['run_seconds'] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell as new files and entries only; the harness finds
    each by its name and runs the cell."""
    root = tmp_path / 'checkout'
    shutil.copytree(BENCH, root / 'npp_bench',
                    ignore=shutil.ignore_patterns('__pycache__', '.tmp'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), root)
    bench_dir = str(root / 'npp_bench')
    cfg = config('npp-completion')
    cfg.update(name='npp-completion-narrow')
    cfg['config'] = dict(cfg['config'], netwidth=64, netdepth=6, N_rand=256)
    cfg['image'] = {'maker': 'completion', 'height': 128, 'width': 192,
                    'patch_size': 32}
    (root / 'npp_bench/configs/npp-completion-narrow.json').write_text(
        json.dumps(cfg))
    (root / 'npp_bench/traffic/two.json').write_text(json.dumps(
        {'images': 2, 'image_seed_offsets': [0, 7], 'block': 8,
         'entry': 'batched_fit_block'}))
    (root / 'npp_bench/metrics/rows_per_step.py').write_text(
        'def read(ctx):\n    return float(ctx.shapes["rows"] * ctx.images)\n')
    (root / 'npp_bench/limits/narrow-two.json').write_text(json.dumps(
        {'limits': {'batch_mismatch': 0, 'pred_gap': 1e-3}}))
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({
        'name': 'npp-completion-narrow', 'source': 'a test',
        'file': 'npp_bench/configs/npp-completion-narrow.json',
        'reduced': [], 'why': 'a test'})
    bench['workloads'].append({'name': 'narrow-two',
                               'config': 'npp-completion-narrow',
                               'traffic': 'two', 'chips': 1, 'why': 'a test'})
    bench['per_layer'].append({
        'name': 'rows_per_step', 'unit': 'rows', 'better': 'higher',
        'source': 'program_counter', 'layer': 'fit step',
        'moves': 'image_steps_per_s', 'workloads': ['narrow-two']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))

    spec = harness.cell_spec(harness.load_benchmark(str(root)), 'narrow-two',
                             str(root), bench_dir)
    assert spec.config['name'] == 'npp-completion-narrow'
    assert spec.traffic['images'] == 2
    assert 'rows_per_step' in {m['name'] for m in spec.per_layer}
    assert harness.reader('rows_per_step', bench_dir)(
        type('C', (), {'shapes': {'rows': 10}, 'images': 2})) == 20.0
    t0 = time.monotonic()
    out = harness.run_cell('narrow-two', 4, 0.05, False,
                           lambda: time.monotonic() - t0, device='cpu',
                           bench_dir=bench_dir, root=str(root))
    assert out['result']['correct'], out['numbers']
    assert out['result']['attempted'] % 2 == 0
    assert set(out['result']['checked']) == {'batch_mismatch', 'pred_gap'}


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    t0 = time.monotonic()
    out = harness.run_cell('completion-flagship', 12345, 2.0, True,
                           lambda: time.monotonic() - t0)
    res = out['result']
    assert res['correct'], out['numbers']
    assert res['device']['platform'] == 'gpu'
    assert 0 < res['device']['busy_s'] <= res['device']['window_s']
    assert {'step_mfu', 'device_idle_share', 'launches_per_step',
            'k2_roofline', 'k3_roofline'} <= set(res['metrics'])
    for name in ('k2_roofline', 'k3_roofline', 'step_mfu'):
        assert 0 < res['metrics'][name]['value'] <= 105
