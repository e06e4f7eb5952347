"""The erf GELU's dispatch and its plain route (CPU).

`gelu_erf` launches the hand-written kernel (`csrc/gelu_erf.cu`) on a CUDA
tensor and runs the plain torch version on a CPU tensor.  Here: the plain
route gives, bit for bit, what the former all-torch implementation gave
(forward with and without a graph, backward); autograd keeps the input, in
its own dtype, as the only residual; a CPU tensor counts no launch; a tensor
on `cuda` reaches the launcher and never the plain route (a stand-in
launcher, no card needed).  The kernel itself is held to the plain version
on the card (`tests/test_torch_kernels_cuda.py`, `chip_smoke.py` phase 24);
the JAX parity tests are `tests/test_torch_dropout.py` and
`tests/test_torch_attention.py`.
"""

import types

import pytest

torch = pytest.importorskip("torch")

from neko_tpu_torch.ops import gelu  # noqa: E402
from neko_tpu_torch.ops.gelu import gelu_erf  # noqa: E402

# ------------------------------------------------ the former implementation
_P, _A1, _A2, _A3, _A4, _A5 = (0.3275911, 0.254829592, -0.284496736, 1.421413741,
                               -1.453152027, 1.061405429)
_INV_SQRT2, _INV_SQRT2PI = 0.7071067811865476, 0.3989422804014327


def _former_erf(z):
    z32 = z.float()
    a = z32.abs()
    t = 1.0 / (1.0 + _P * a)
    poly = t * (_A1 + t * (_A2 + t * (_A3 + t * (_A4 + t * _A5))))
    return torch.sign(z32) * (1.0 - poly * torch.exp(-a * a))


def _former_gelu_and_grad(x):
    x32 = x.float()
    a = x32.abs() * _INV_SQRT2
    t = 1.0 / (1.0 + _P * a)
    poly = t * (_A1 + t * (_A2 + t * (_A3 + t * (_A4 + t * _A5))))
    ex = torch.exp(-a * a)
    cdf = 0.5 * (1.0 + torch.sign(x32) * (1.0 - poly * ex))
    return x32 * cdf, cdf + x32 * (_INV_SQRT2PI * ex)


def _former_no_grad(x):
    x32 = x.float()
    return (x32 * (0.5 * (1.0 + _former_erf(x32 * _INV_SQRT2)))).to(x.dtype)


def _inputs(dtype, n=1 << 16):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(n, generator=g) * 4
    x[:6] = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 12.0, -12.0])
    return x.to(dtype), torch.randn(n, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_route_is_the_former_code_bit_for_bit(dtype):
    x, g = _inputs(dtype)
    y_former, dy = _former_gelu_and_grad(x)
    assert torch.equal(gelu_erf(x), _former_no_grad(x))
    with torch.no_grad():
        assert torch.equal(gelu_erf(x.clone().requires_grad_()), _former_no_grad(x))
    xg = x.clone().requires_grad_()
    y = gelu_erf(xg)
    assert y.dtype == dtype and torch.equal(y.detach(), y_former.to(dtype))
    y.backward(g)
    assert xg.grad.dtype == dtype
    assert torch.equal(xg.grad, (g.float() * dy).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_saves_the_input_not_an_fp32_derivative(dtype):
    x = _inputs(dtype, 4096)[0].reshape(16, 256).requires_grad_()
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = gelu_erf(x)
    assert len(saved) == 1
    assert saved[0].dtype == dtype and saved[0].shape == x.shape
    assert saved[0] is x  # the input itself: no copy, no fp32 gelu'(x)
    y.sum().backward()
    assert x.grad.shape == x.shape


def test_cpu_tensors_launch_nothing():
    before = gelu_erf.launches
    x, g = _inputs(torch.bfloat16, 1000)
    gelu_erf(x)
    xg = x.clone().requires_grad_()
    gelu_erf(xg).backward(g)
    assert gelu_erf.launches == before


class _OnCuda:
    """What the dispatch reads of a tensor on a card: its device and whether
    it needs a gradient."""

    device = torch.device("cuda")
    requires_grad = False


def test_a_cuda_tensor_reaches_the_launcher_and_never_the_plain_route(monkeypatch):
    calls = []
    monkeypatch.setattr(gelu, "_launch", lambda name, *t: calls.append((name, t)) or "launched")

    def refuse(*args):
        raise AssertionError("the plain route ran for a CUDA tensor")

    monkeypatch.setattr(gelu, "gelu_erf_reference", refuse)
    monkeypatch.setattr(gelu, "gelu_erf_grad_reference", refuse)
    x, g = _OnCuda(), _OnCuda()
    assert gelu_erf(x) == "launched"
    assert gelu._backward(x, g) == "launched"
    assert calls == [("gelu_erf_fwd", (x,)), ("gelu_erf_bwd", (x, g))]


def test_the_backward_gets_the_saved_input(monkeypatch):
    seen = []
    backward = gelu._backward
    monkeypatch.setattr(gelu, "_backward", lambda x, g: seen.append(x) or backward(x, g))
    x = _inputs(torch.float32, 256)[0].requires_grad_()
    gelu_erf(x).sum().backward()
    assert len(seen) == 1 and seen[0] is x


def test_other_devices_and_dtypes_are_refused():
    with pytest.raises(ValueError, match="no gelu_erf for device meta"):
        gelu_erf(torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="no gelu_erf for device meta"):
        gelu._backward(types.SimpleNamespace(device=torch.device("meta")), None)
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            gelu._launch("gelu_erf_fwd", torch.zeros(8, dtype=dtype))
    with pytest.raises(ValueError, match="gradient"):
        gelu._launch("gelu_erf_bwd", torch.zeros(8), torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="gradient"):
        gelu._launch("gelu_erf_bwd", torch.zeros(8), torch.zeros(4))


@pytest.mark.parametrize("shape,strides_of", [
    ((4, 3, 16, 16), lambda t: t),                           # contiguous
    ((4, 16, 16, 3), lambda t: t.permute(0, 3, 1, 2)),       # NHWC seen as NCHW: kept
    ((4, 3, 16, 32), lambda t: t[..., ::2]),                 # strided: made contiguous
])
def test_the_launcher_runs_on_one_dense_layout(shape, strides_of):
    x = strides_of(torch.randn(shape))
    g = torch.randn(x.shape)  # contiguous
    (xd,), out = gelu._dense_alike(x)
    assert out.stride() == xd.stride() and out.shape == x.shape
    assert xd.is_contiguous() or xd is x
    if x.is_contiguous(memory_format=torch.channels_last):  # dense: its own layout
        assert xd is x and not out.is_contiguous()
    (xd, gd), out = gelu._dense_alike(x, g)
    assert xd.stride() == gd.stride() == out.stride()
    assert torch.equal(xd, x) and torch.equal(gd, g)
