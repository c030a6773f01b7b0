"""Nothing the benchmark runs may load JAX or the JAX package: every module
that npp_bench/run.py reaches (its own files, the metric readers it loads
by name, and every module of npp_tpu_torch that those import) is walked,
and each imported top-level name (the part before the first dot) is
compared whole with the forbidden ones; then a run of a cell at a tiny
size in a fresh process shows the same in its sys.modules."""
import ast
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'npp_tpu'}
OWN = ('npp_bench', 'npp_tpu_torch')


def _module_file(name: str):
    base = os.path.join(ROOT, *name.split('.'))
    for cand in (base + '.py', os.path.join(base, '__init__.py')):
        if os.path.exists(cand):
            return cand
    return None


def _imports(path: str, module: str):
    """(module names imported by the file, relative imports resolved)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    package = module if path.endswith('__init__.py') \
        else module.rpartition('.')[0]
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split('.')
                base = '.'.join(parts[:len(parts) - node.level + 1])
                mod = f'{base}.{node.module}' if node.module else base
            else:
                mod = node.module
            names.add(mod)
            names.update(f'{mod}.{a.name}' for a in node.names)
    return names


def _reachable():
    """Every module name reached from run.py and the metric readers."""
    start = ['npp_bench.run', 'npp_bench.calibrate'] + [
        f'npp_bench.metrics.{f[:-3]}'
        for f in os.listdir(os.path.join(BENCH, 'metrics'))
        if f.endswith('.py')]
    seen, todo, names = set(), list(start), set()
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
    return seen, names


def test_no_forbidden_import_is_reachable():
    seen, names = _reachable()
    assert 'npp_bench.harness' in seen and 'npp_tpu_torch.models.trainer' \
        in seen and 'npp_tpu_torch.parallel.batch' in seen
    tops = {n.split('.')[0] for n in names}
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)
    # the port's own name begins with the JAX package's: compared whole
    assert 'npp_tpu_torch' in tops


def test_a_run_loads_no_forbidden_module():
    code = f"""
import json, sys, time
sys.path.insert(0, {ROOT!r})
import torch
from npp_bench import harness
t0 = time.monotonic()
ov = {{'config': {{'netwidth': 32, 'netdepth': 6, 'N_rand': 128}},
      'traffic': {{'block': 8}},
      'image': {{'height': 128, 'width': 192, 'patch_size': 32}}}}
harness.run_cell('completion-flagship', 3, 0.1, False,
                 lambda: time.monotonic() - t0, device='cpu', overrides=ov)
print(json.dumps(harness.forbidden_modules()))
"""
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole():
    from npp_bench import harness
    names = ['npp_tpu_torch', 'npp_tpu_torch.models.trainer', 'jax_like',
             'flaxen', 'npp_bench.harness', 'optax_free.x']
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ['npp_tpu.models', 'jaxlib',
                                              'jax.numpy']) == [
        'jax', 'jaxlib', 'npp_tpu']
