"""Port parity on the CPU for the per-block canvas embedding table
(cfg.embed_table): the port decides table / no table / dtype as `npp_tpu`
does, and its bfloat16 table holds npp_tpu's values. The fit step through
that table is in tests/test_torch_trainer.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npp_tpu.config import CompletionConfig as JaxCompletionConfig
from npp_tpu.config import replace as jax_replace
from npp_tpu.models import trainer as JT
from npp_tpu.models.completion import COMPLETION_TASK
from npp_tpu.nn import embedder as JE
from npp_tpu_torch import config as TC
from npp_tpu_torch.models import trainer as TT
from npp_tpu_torch.nn import embedder as TE
from npp_tpu_torch.utils.convert import params_from_jax
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

RES = (40, 48)
ANGLES = np.array([[90.0, 180.0], [10.0, 100.0], [45.0, 135.0]])
PERIODS = np.array([[10.0, 12.0], [12.0, 14.5], [24.0, 28.0]])


def _embedders():
    """npp_tpu's and the port's TaskEmbedder on the same proposals and
    Fourier bands. At 40x48 and 1386 channels the f32 table is 10.6 MB."""
    je = JE.make_task_embedder(JaxCompletionConfig(), ANGLES, PERIODS, RES,
                               jax.random.PRNGKey(0))
    te = TE.make_task_embedder(TC.CompletionConfig(), ANGLES, PERIODS, RES,
                               torch.Generator().manual_seed(0),
                               torch.device('cpu'))
    te.freq_bands = params_from_jax({'embedder': {
        'freq_bands': np.asarray(je.freq_bands)}})['embedder']['freq_bands']
    return je, te


def _jax_table_dtype(cfg, embedder, block):
    """What npp_tpu's make_fit_block decides (trainer.py:293-312), read
    from its block function's closure; the step's other parts are not
    built until it runs."""
    run_block = JT.make_fit_block(cfg, COMPLETION_TASK, None, embedder, None,
                                  None, None, None, None, 1, 16, block)
    fn = run_block.__wrapped__
    env = dict(zip(fn.__code__.co_freevars,
                   (c.cell_contents for c in fn.__closure__)))
    if not env['use_table']:
        return None
    return {jnp.float32: torch.float32,
            jnp.bfloat16: torch.bfloat16}[env['table_dtype']]


@pytest.mark.parametrize('table,max_mb,degrade,block,want', [
    ('float32', 2048, False, 10, torch.float32),
    ('bfloat16', 2048, False, 10, torch.bfloat16),
    ('', 2048, False, 10, None),
    ('float32', 2048, False, 5, None),       # tiny blocks: no table
    ('float32', 8, False, 10, None),         # 10.6 MB > 8: on the fly
    ('float32', 8, True, 10, torch.bfloat16),  # degraded: 5.3 MB fits
    ('float32', 4, True, 10, None),          # not even in bf16
    ('bfloat16', 4, True, 10, None),         # degrade applies to f32 only
])
def test_table_dtype_matches_jax(table, max_mb, degrade, block, want):
    kw = dict(embed_table=table, embed_table_max_mb=max_mb,
              embed_table_degrade=degrade)
    je, te = _embedders()
    got = TT.table_dtype(TC.replace(TC.CompletionConfig(), **kw), te, block)
    assert got == want
    assert _jax_table_dtype(jax_replace(JaxCompletionConfig(), **kw), je,
                            block) == want


def test_bf16_table_matches_jax():
    """The port's bfloat16 table (the plain version of K1 rounded to
    nearest even) against npp_tpu's make_embedding_table(..., bfloat16).
    The two f32 tables differ by f32 rounding of the trig chain (~1e-5
    absolute, tests/test_torch_nn.py), so a value may round to the
    neighbouring bf16: each value lies within one bf16 ulp plus that f32
    difference (which only matters near zero, where the ulp is tiny). The
    rows come back from the gather as f32, as npp_tpu's matmul promotes
    them."""
    je, te = _embedders()
    want = np.asarray(JE.make_embedding_table(je, jnp.bfloat16).table
                      ).astype(np.float32)
    f32_diff = np.abs(
        TE.make_embedding_table(te, torch.float32).table.numpy() -
        np.asarray(JE.make_embedding_table(je, jnp.float32).table))
    table = TE.make_embedding_table(te, torch.bfloat16)
    assert table.table.dtype == torch.bfloat16
    got = table.table.float().numpy()
    assert got.shape == want.shape == (RES[0] * RES[1], te.out_dim)
    ulp = np.exp2(np.floor(np.log2(np.maximum(
        np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= ulp + f32_diff)
    assert f32_diff.max() < 1e-4
    coords = torch.tensor([[0.0, 0.0], [39.0, 47.0], [17.0, 5.0]])
    rows = table.embed(coords)
    assert rows.dtype == torch.float32
    np.testing.assert_array_equal(rows.numpy(), got[[0, 39 * 48 + 47,
                                                     17 * 48 + 5]])
