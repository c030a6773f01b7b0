"""The small sizes the benchmark's CPU tests run its cells at: every width
and shape of the configuration files cut so that a test holds them."""
import time

CELLS = ('completion-flagship', 'completion-batch3')


def overrides(cell: str) -> dict:
    image = {'height': 128, 'width': 192, 'patch_size': 32} \
        if cell.startswith('completion') else \
        {'height': 192, 'width': 256, 'patch_size': 64}
    return {'config': {'netwidth': 64, 'netdepth': 6, 'N_rand': 256},
            'traffic': {'block': 8}, 'image': image}


def run(cell: str, seed: int = 5, **kw) -> dict:
    """One run of `cell` on the CPU at the small size."""
    from npp_bench import harness
    t0 = time.monotonic()
    return harness.run_cell(cell, seed, 0.05, False,
                            lambda: time.monotonic() - t0, device='cpu',
                            overrides=overrides(cell), **kw)


def with_remapping(tmp_path) -> dict:
    """A copy of the benchmark whose BENCHMARK.json gains the remapping
    cell, whose configuration, traffic and limits files are there already
    (PERF.md: the cell waits for a steadier host-bound rate): the keywords
    that make run() and harness.cell_spec read the copy."""
    import json
    import os
    import shutil
    from npp_bench import harness
    root = tmp_path / 'checkout'
    shutil.copytree(harness.BENCH, root / 'npp_bench',
                    ignore=shutil.ignore_patterns('__pycache__', '.tmp'))
    bench = harness.load_benchmark()
    bench['configs'].append({
        'name': 'npp-remapping', 'source': 'NPP-Net remapping_config',
        'file': 'npp_bench/configs/npp-remapping.json', 'reduced': [],
        'why': 'remapping'})
    bench['workloads'].append({
        'name': 'remapping-flagship', 'config': 'npp-remapping',
        'traffic': 'flagship', 'chips': 1, 'why': 'remapping'})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return {'bench_dir': os.path.join(str(root), 'npp_bench'),
            'root': str(root)}
