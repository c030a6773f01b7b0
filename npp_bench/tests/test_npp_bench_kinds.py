"""Kinds of program found by name (programs/<entry>.py), on the CPU:

 - a copy of the benchmark gains a kind that is not a fit (new_kind/: a
   stacked MLP regression with its own plain reference, configuration,
   traffic, limits, cell and a per-layer metric reading its work) as new
   files and BENCHMARK.json entries only; harness.run_cell runs it to
   `correct`, a planted fault reads not correct, and every file that was
   in the copy is byte-equal afterwards;
 - the fit kinds read what the fits' steps read before they were kinds,
   bit for bit (fit_readings.json, recorded on the commit before): every
   check number of both cells and of the remapping copy at small.py's
   sizes, the FLOP counts and shapes, the readers on
   test_npp_bench_harness.py's made-up profile through the kinds' declared
   work, and K2's and K3's bounds;
 - K3's bound at the f32 peak (the search's eval), and readers that do not
   raise on a configuration without the fits' keys."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from npp_bench import flops, harness
from small import CELLS, overrides, with_remapping
from test_npp_bench_harness import _summary
from test_npp_bench_imports import FORBIDDEN, OWN, _imports, _module_file

HERE = os.path.dirname(os.path.abspath(__file__))
NEW_KIND = os.path.join(HERE, 'new_kind')
CELL = 'stacked-mlp-regression'
H100_NAME = 'NVIDIA H100 80GB HBM3'
H100 = flops.peaks(H100_NAME)
READERS = ('step_mfu', 'device_idle_share', 'launches_per_step',
           'k2_roofline', 'k3_roofline')


def _golden() -> dict:
    with open(os.path.join(HERE, 'fit_readings.json')) as f:
        return json.load(f)


def _hashes(root) -> dict:
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != '__pycache__']
        for name in files:
            path = os.path.join(d, name)
            with open(path, 'rb') as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def _with_new_kind(tmp_path) -> dict:
    """A copy of the benchmark with new_kind/'s files added at the same
    paths under its npp_bench/ and the cell, configuration and metric
    appended to its BENCHMARK.json."""
    root = tmp_path / 'checkout'
    shutil.copytree(harness.BENCH, root / 'npp_bench',
                    ignore=shutil.ignore_patterns('__pycache__', '.tmp'))
    shutil.copy(os.path.join(harness.ROOT, 'BENCHMARK.json'), root)
    before = _hashes(str(root))
    added = []
    for d, _, files in os.walk(NEW_KIND):
        for name in files:
            rel = os.path.relpath(os.path.join(d, name), NEW_KIND)
            dest = root / 'npp_bench' / rel
            assert not dest.exists(), rel
            shutil.copy(os.path.join(d, name), dest)
            added.append(rel)
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({
        'name': 'stacked-mlp', 'source': 'a test',
        'file': 'npp_bench/configs/stacked-mlp.json', 'reduced': [],
        'why': 'a kind of program that is not a fit'})
    bench['workloads'].append({
        'name': CELL, 'config': 'stacked-mlp', 'traffic': 'regression',
        'chips': 1, 'why': 'a test'})
    bench['per_layer'].append({
        'name': 'regression_gemm_gflop', 'unit': 'GFLOP', 'better': 'higher',
        'source': 'program_counter', 'layer': 'fit step',
        'moves': 'image_steps_per_s', 'workloads': [CELL]})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return {'root': str(root), 'bench_dir': str(root / 'npp_bench'),
            'before': before, 'added': sorted(added)}


def _run(at) -> dict:
    t0 = time.monotonic()
    return harness.run_cell(CELL, 2 ** 31 + 17, 0.05, False,
                            lambda: time.monotonic() - t0, device='cpu',
                            bench_dir=at['bench_dir'], root=at['root'])


def test_a_new_kind_is_new_files_only(tmp_path):
    at = _with_new_kind(tmp_path)
    assert 'programs/stacked_mlp_regression.py' in at['added']
    spec = harness.cell_spec(harness.load_benchmark(at['root']), CELL,
                             at['root'], at['bench_dir'])
    assert spec.traffic['entry'] == 'stacked_mlp_regression'
    out = _run(at)
    res = out['result']
    assert res['correct'], out['numbers']
    assert set(res['checked']) == {'loss_gap', 'change_gap'}
    assert out['numbers']['loss_gap'] < 1e-5
    # 4 models a step, blocks of 5 steps
    assert res['attempted'] % 20 == 0 and res['failed'] == 0
    assert set(res['metrics']) == {'image_steps_per_s', 'peak_mem_gib',
                                   'setup_s'}

    # its metric reads its work; no reader of the copy raises on a
    # configuration without the fits' keys
    kind = harness.kind('stacked_mlp_regression', at['bench_dir'])
    work = kind.work(spec.config, spec.traffic)
    ctx = harness.reader_context(_summary(), 40.0, 1 / 40.0, spec.config,
                                 spec.traffic, 4, work, H100_NAME,
                                 at['bench_dir'])
    assert harness.reader('regression_gemm_gflop', at['bench_dir'])(ctx) == \
        pytest.approx(3 * 2 * 4 * 64 * (8 * 32 + 32 * 1) / 1e9)
    got = {m['name']: harness.reader(m['name'], at['bench_dir'])(ctx)
           for m in spec.per_layer}
    assert got['k2_roofline'] is None and got['k3_roofline'] is None
    assert got['step_mfu'] == pytest.approx(
        100 * work['flops']['total'] * 40 / H100['f32'])

    # every file that was in the copy is unchanged; BENCHMARK.json only
    # gained entries
    after = _hashes(at['root'])
    changed = sorted(k for k, v in at['before'].items() if after[k] != v)
    assert changed == ['BENCHMARK.json']
    old, new = harness.load_benchmark(), harness.load_benchmark(at['root'])
    for key, value in old.items():
        if isinstance(value, list):
            assert new[key][:len(value)] == value
        else:
            assert new[key] == value


def test_a_new_kinds_planted_fault_is_not_correct(tmp_path, monkeypatch):
    """Its step returns its state unchanged: Adam takes no step."""
    import torch
    at = _with_new_kind(tmp_path)
    monkeypatch.setattr(torch.optim.Adam, 'step',
                        lambda self, closure=None: None)
    out = _run(at)
    assert out['result']['correct'] is False
    assert out['numbers']['change_gap'] > out['limits']['change_gap']


# One run of a cell at small.py's size in a fresh process, printing its
# numbers and both sides' losses: the CPU's products and norms sum in an
# order that follows the number of threads (PyTorch's and the BLAS's), so
# the readings are taken, and were recorded, with four of each.
FRESH = """
import json, sys
sys.path[:0] = [{root!r}, {tests!r}]
import small
cell = {cell!r}
at = small.with_remapping(__import__('pathlib').Path({tmp!r})) \\
    if cell.startswith('remapping') else {{}}
out = small.run(cell, **at)
print(json.dumps([out['numbers'], [out['diag']['program_losses'],
                                   out['diag']['reference_losses']]]))
"""
THREADS = {k: '4' for k in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS',
                            'OPENBLAS_NUM_THREADS')}


def fresh_run(cell: str, tmp: str, root: str = harness.ROOT) -> list:
    """[numbers, [program losses, reference losses]] of `cell` run by the
    benchmark at `root` in a fresh process with four threads."""
    code = FRESH.format(root=root, tests=os.path.join(root, 'npp_bench',
                                                      'tests'),
                        cell=cell, tmp=tmp)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, **THREADS))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('cell', CELLS + ('remapping-flagship',))
def test_check_numbers_unchanged(cell, tmp_path):
    numbers, losses = fresh_run(cell, str(tmp_path))
    want = _golden()['numbers']
    assert numbers == want[cell]
    assert losses == want[f'{cell}:losses']


def test_work_and_readers_unchanged(tmp_path):
    """The FLOP counts and shapes at both sizes, and the readers' values
    on the made-up profile through each fit kind's declared work."""
    want = _golden()
    remap = with_remapping(tmp_path)
    for cell in CELLS + ('remapping-flagship',):
        at = remap if cell.startswith('remapping') else \
            {'bench_dir': harness.BENCH, 'root': harness.ROOT}
        spec = harness.cell_spec(harness.load_benchmark(at['root']), cell,
                                 at['root'], at['bench_dir'])
        for size in ('full', 'small'):
            cfg, tr = (spec.config, spec.traffic) if size == 'full' else \
                harness.apply_overrides(spec.config, spec.traffic,
                                        overrides(cell))
            key = f'{cell}:{size}'
            kind = harness.kind(tr['entry'], at['bench_dir'])
            work = kind.work(cfg, tr)
            assert work['flops'] == want['flops'][key]
            assert flops.step_shapes(cfg) == want['shapes'][key]
            ctx = harness.reader_context(
                _summary(), 40.0, 1 / 40.0, cfg, tr,
                len(tr['image_seed_offsets']), work, H100_NAME,
                at['bench_dir'])
            got = {n: harness.reader(n, at['bench_dir'])(ctx)
                   for n in READERS}
            assert got == want['readers'][key], key


def test_bounds_unchanged():
    want = _golden()
    for rows, width, bounds in want['k2']:
        assert list(flops.k2_bounds(rows, width, H100)) == bounds
    for n, p, c, dx, dy, mask, bounds in want['k3']:
        assert list(flops.k3_bounds(n, p, p, c, H100, need_dx=dx,
                                    need_dy=dy, mask=mask)) == bounds


def test_k3_bound_at_the_f32_peak():
    """The search's eval: K3 in f32 FFMA at 3 x 12,288 x 12,288 x 256,
    masked, forward only: 3.4616 ms (PERF.md's table of kernels); TF32
    stays the default."""
    item = {'n': 3, 'p': 12288, 'q': 12288, 'c': 256, 'dx': False,
            'dy': False, 'masked': True, 'precision': 'f32'}
    assert flops.k3_least(item, H100) * 1e3 == pytest.approx(3.4616,
                                                             rel=0.01)
    fwd, _ = flops.k3_bounds(3, 12288, 12288, 256, H100, need_dx=False,
                             mask=True)
    assert fwd * 1e3 == pytest.approx(3.4616 * 67 / 495, rel=0.01)
    assert flops.k3_least(dict(item, precision='tf32'), H100) == fwd


def test_readers_do_not_raise_without_fit_keys():
    """A configuration without towers, mlp or image.patch_size, and work
    that declares nothing: every reader returns None."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(
        harness.BENCH, 'metrics')) if f.endswith('.py'))
    for work in ({}, {'kernels': {}}):
        ctx = harness.reader_context(_summary(), 40.0, 1 / 40.0,
                                     {'name': 'x', 'image': {}}, {}, 1,
                                     work, H100_NAME)
        for name in names:
            assert harness.reader(name)(ctx) is None or name in (
                'device_idle_share', 'launches_per_step'), name


def test_kinds_reach_no_forbidden_import():
    """The kinds (loaded by path, so outside run.py's import walk), walked
    as test_npp_bench_imports walks run.py."""
    kinds = [f[:-3] for f in os.listdir(os.path.join(harness.BENCH,
                                                     'programs'))
             if f.endswith('.py') and f != '__init__.py']
    assert {'fit_block', 'batched_fit_block'} <= set(kinds)
    seen, todo, names = set(), [f'npp_bench.programs.{k}' for k in kinds], \
        set()
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = _module_file(mod)
        if path is None:
            continue
        for name in _imports(path, mod):
            names.add(name)
            if name.split('.')[0] in OWN:
                todo.append(name)
    assert 'npp_tpu_torch.models.trainer' in seen
    assert not {n.split('.')[0] for n in names} & FORBIDDEN
