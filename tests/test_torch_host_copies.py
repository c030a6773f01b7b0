"""The fit's host-to-card copies on the CPU: the robust loss's spline and
ImageNet's mean and std are copied to a device once and cached, bit-equal
to the host arrays, and the functions that read them give what the
per-call copies gave; `device.py::to_device_async`, which stages the
per-step draws, is a plain `.to` on the CPU. The card's side (no sync in
the step, pinned copies equal to the draws) is in
`tests/test_torch_tracing.py`."""
import numpy as np
import pytest
import torch

from npp_tpu_torch.device import to_device_async
from npp_tpu_torch.losses import robust as TR
from npp_tpu_torch.nn import features as TF
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

CPU = torch.device('cpu')


def _alphas(dtype):
    # both sides of the spline's curve (alpha 4), its ends and beyond
    a = np.concatenate([[0.0, 1e-6, 0.5, 1.0, 2.0, 3.999, 4.0, 4.001, 10.0,
                         100.0, 1e4, 1e6],
                        np.random.RandomState(0).gamma(1.0, 3.0, 200)])
    return torch.as_tensor(a, dtype=dtype)


def test_spline_on_a_device_equals_the_host_arrays_and_is_kept():
    _, values, tangents = TR._load_spline()
    v, t = TR._spline_on(CPU)
    assert v.dtype == t.dtype == torch.float32 and v.device == CPU
    np.testing.assert_array_equal(v.numpy(), values)
    np.testing.assert_array_equal(t.numpy(), tangents)
    v2, t2 = TR._spline_on(CPU)
    assert v2 is v and t2 is t


def test_imagenet_stats_on_a_device_equal_the_host_arrays_and_are_kept():
    mean, std = TF._imagenet_stats_on(CPU)
    assert mean.dtype == std.dtype == torch.float32 and mean.device == CPU
    np.testing.assert_array_equal(mean.numpy(), TF.IMAGENET_MEAN)
    np.testing.assert_array_equal(std.numpy(), TF.IMAGENET_STD)
    mean2, std2 = TF._imagenet_stats_on(CPU)
    assert mean2 is mean and std2 is std


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_log_partition_equals_the_per_call_copies(dtype):
    alpha = _alphas(dtype)
    x_scale, values, tangents = TR._load_spline()
    want = TR.interpolate1d(TR.partition_spline_curve(alpha) * x_scale,
                            torch.as_tensor(values), torch.as_tensor(tangents))
    got = TR.log_base_partition_function(alpha)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    # the gradient the losses take through it, too
    a1 = alpha.clone().requires_grad_(True)
    a2 = alpha.clone().requires_grad_(True)
    TR.log_base_partition_function(a1).sum().backward()
    TR.interpolate1d(TR.partition_spline_curve(a2) * x_scale,
                     torch.as_tensor(values),
                     torch.as_tensor(tangents)).sum().backward()
    assert torch.equal(a1.grad, a2.grad)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_imagenet_normalize_equals_the_per_call_copies(dtype):
    img = torch.as_tensor(np.random.RandomState(1).rand(2, 9, 7, 3),
                          dtype=dtype)
    want = (img - torch.as_tensor(TF.IMAGENET_MEAN)) / torch.as_tensor(
        TF.IMAGENET_STD)
    got = TF.imagenet_normalize(img)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize('t', [
    torch.arange(7, dtype=torch.long) * 977,
    torch.tensor([True, False, True]),
    torch.randint(0, 2 ** 40, (2, 5), generator=torch.Generator()
                  .manual_seed(3)),
    torch.rand(4, 3, generator=torch.Generator().manual_seed(4)),
], ids=['long', 'bool', 'long2d', 'float'])
def test_staging_on_the_cpu_is_a_plain_copy(t):
    want = t.clone()
    got = to_device_async(t, CPU)
    assert got.device == CPU and got.dtype == t.dtype
    assert torch.equal(got, want)
