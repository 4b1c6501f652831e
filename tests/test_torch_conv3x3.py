"""``ops/kernels.py``'s conv3x3 entry points on the CPU: the plain versions
(written-out PyTorch with the kernels' argument roles) against
``F.conv2d`` and its autograd gradients; ``gradcheck`` and
``gradgradcheck`` of the three autograd Functions, whose backwards are
each other; a second-order MAML step of Conv-4 through them against the
``F.conv2d`` chain in fp64, with the calls of each entry point the card
launches; the backbones' dispatch (the CPU, bf16 and fp64 keep
``F.conv2d``); the plan, at conv4's and ResNet-12's calls, and what it
refuses. The kernels themselves are
held against fp64 ``F.conv2d`` on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from fumi_tpu_torch.core.episode import Episode
from fumi_tpu_torch.metalearn import inner_loop
from fumi_tpu_torch.models import conv4, layers, resnet12
from fumi_tpu_torch.ops import kernels

F64 = torch.float64
ENTRIES = (kernels.conv3x3_fprop, kernels.conv3x3_dgrad, kernels.conv3x3_wgrad)


def conv_inputs(M, G, cin, cout, H, W, seed, dtype=F64):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype)
    return r(M, G * cin, H, W), r(G * cout, cin, 3, 3), r(M, G * cout, H, W)


def library(x, w, gy, G):
    """F.conv2d's output and its autograd input and weight gradients."""
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = F.conv2d(xr, wr, padding=1, groups=G)
    gx, gw = torch.autograd.grad(y, (xr, wr), gy)
    return y.detach(), gx, gw


def close(got, want, tol=1e-12):
    scale = max(float(want.detach().abs().max()), 1.0)
    assert float((got - want).detach().abs().max()) <= tol * scale


@pytest.mark.parametrize("G,cin,cout,H,W", [
    (1, 3, 8, 7, 6), (4, 3, 4, 5, 5), (4, 8, 4, 6, 9), (2, 4, 12, 1, 4),
    (3, 16, 8, 10, 10)])
def test_plain_versions_match_conv2d_and_its_gradients(G, cin, cout, H, W):
    """fp64, odd and even sides, a one-row image, the narrow channel count
    of images (3) and multiples of 4."""
    x, w, gy = conv_inputs(2, G, cin, cout, H, W, seed=G + cin + H)
    y, gx, gw = library(x, w, gy, G)
    close(kernels.conv3x3_fprop_reference(x, w, G), y)
    close(kernels.conv3x3_dgrad_reference(gy, w, G), gx)
    close(kernels.conv3x3_wgrad_reference(x, gy, G), gw)
    # the entry points on the CPU are the plain versions
    close(kernels.conv3x3_fprop(x, w, G), y)
    close(kernels.conv3x3_dgrad(gy, w, G), gx)
    close(kernels.conv3x3_wgrad(x, gy, G), gw)


def test_plain_versions_in_fp32_near_fp64():
    x, w, gy = conv_inputs(3, 4, 8, 8, 9, 9, seed=1, dtype=torch.float32)
    y, gx, gw = library(*(t.double() for t in (x, w, gy)), 4)
    close(kernels.conv3x3_fprop(x, w, 4).double(), y, tol=1e-6)
    close(kernels.conv3x3_dgrad(gy, w, 4).double(), gx, tol=1e-6)
    close(kernels.conv3x3_wgrad(x, gy, 4).double(), gw, tol=1e-6)


@pytest.mark.parametrize("entry", range(3), ids=["fprop", "dgrad", "wgrad"])
@pytest.mark.parametrize("G,cin,side", [(1, 3, 5), (1, 8, 4), (4, 3, 4),
                                        (4, 8, 3)])
def test_gradcheck_and_gradgradcheck(entry, G, cin, side):
    """Each Function's backward (the other two) and its backward's backward
    (the three again) against finite differences, fp64."""
    x, w, gy = conv_inputs(1, G, cin, 4, side, side, seed=entry + side)
    args = ((x, w), (gy, w), (x, gy))[entry]
    args = tuple(t.requires_grad_() for t in args)

    def fn(a, b):
        return ENTRIES[entry](a, b, G)
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


def maml_episode(gen, side, B, S, Q, ways):
    x = torch.rand(B, S + Q, side, side, 3, generator=gen, dtype=F64)
    y = torch.arange(ways).repeat(B, (S + Q) // ways)
    return Episode(support_im=x[:, :S], support_text=None,
                   support_text_mask=None, support_ids=None,
                   support_y=y[:, :S], query_im=x[:, S:], query_ids=None,
                   query_y=y[:, S:])


def test_maml_second_order_step_through_the_functions(monkeypatch):
    """A second-order MAML step through Conv-4 (2 tasks as channel groups,
    2 inner steps, a 20-pixel side so block 2 is odd) with every
    convolution on the Functions equals the F.conv2d chain's in fp64, and
    calls each entry point as often as the card launches it: for n inner
    steps and 4 blocks, 11n + 4 forwards, 11n + 4 weight gradients, 9n + 3
    input gradients (block 0's images take none)."""
    gen = torch.Generator().manual_seed(0)
    params = {k: v.double() for k, v in
              conv4.init(gen, im_size=20, hidden=8, n_way=3).items()}
    episode = maml_episode(gen, 20, B=2, S=6, Q=9, ways=3)
    n = 2

    def step():
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss, _ = inner_loop.maml_episode_loss(
            conv4.apply, leaves, episode, n_steps=n, step_size=0.1,
            first_order=False)
        return [loss] + list(torch.autograd.grad(loss, list(leaves.values())))

    want = step()
    counts = {"fprop": 0, "dgrad": 0, "wgrad": 0}
    conv = kernels._conv

    def counted(kind, a, b, groups):
        counts[kind] += 1
        return conv(kind, a, b, groups)
    monkeypatch.setattr(kernels, "_conv", counted)
    monkeypatch.setattr(conv4, "conv_kernel_applies", lambda *a: True)
    got = step()
    assert counts == {"fprop": 11 * n + 4, "wgrad": 11 * n + 4,
                      "dgrad": 9 * n + 3}
    for a, b in zip(got, want):
        close(a, b, tol=1e-10)


def test_dispatch_keeps_conv2d_off_the_card(monkeypatch):
    """The CPU in fp32 and fp64, and bf16, never reach the kernels' entry
    point, in conv4 or in resnet12: ``F.conv2d`` computes every
    convolution, the 1×1 shortcuts too."""
    calls = []
    monkeypatch.setattr(kernels, "conv3x3_fprop",
                        lambda *a: calls.append(a))
    library_calls = []
    conv2d = F.conv2d

    def counted(*a, **k):
        library_calls.append(a[0].dtype)
        return conv2d(*a, **k)
    monkeypatch.setattr(layers.F, "conv2d", counted)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(2, 5, 16, 16, 3, generator=gen)
    p4 = conv4.init(gen, im_size=16, hidden=8, n_way=5)
    p12 = resnet12.init(gen, im_size=16, channels=(4, 6, 8, 8), n_way=5)
    for dtype, cd in ((torch.float32, None), (F64, None),
                      (torch.float32, torch.bfloat16)):
        y, _ = conv4.to_groups(x.to(dtype))
        low = conv4.is_low_precision(cd)
        assert not conv4.conv_kernel_applies(y, p4["convs.1.weight"], 2, low)
        conv4.apply({k: v.to(dtype) for k, v in p4.items()}, x.to(dtype), cd)
        resnet12.apply({k: v.to(dtype) for k, v in p12.items()}, x.to(dtype),
                       cd)
    assert calls == []
    assert len(library_calls) == 3 * (4 + 12 + 4)


def test_dispatch_takes_the_kernels_where_they_apply(monkeypatch):
    """Where the rule holds, conv_block runs the entry point (here its
    plain version) and computes what F.conv2d's block computes; channel
    counts the kernels do not take stay on F.conv2d."""
    monkeypatch.setattr(conv4, "fused_norm_applies", lambda z, low: not low)
    gen = torch.Generator().manual_seed(1)
    p = conv4.unit({f"u.{k}": v.double() for k, v in
                    conv4.conv_init(gen, 8, 12).items()}, "u", 1)
    y = torch.randn(3, 8, 9, 9, generator=gen, dtype=F64)
    assert conv4.conv_kernel_applies(y, p["weight"], 1, False)
    calls = []
    entry = kernels.conv3x3_fprop

    def counted(*a):
        calls.append(a[2])
        return entry(*a)
    monkeypatch.setattr(kernels, "conv3x3_fprop", counted)
    got = conv4.conv_block(p, y)
    monkeypatch.setattr(conv4, "conv_kernel_applies", lambda *a: False)
    close(got, conv4.conv_block(p, y))
    assert calls == [1]
    odd = {k: v[:6] if v.dim() else v for k, v in p.items()}
    assert not conv4.conv_kernel_applies(y, odd["weight"], 1, False)


def test_plan():
    """conv4.train's calls on 132 SMs: 128-pixel tiles where they fill a
    wave of two blocks an SM, 64 below (block 3 of the support set);
    wgrad splits for two such waves, at least 4 chunks each where there
    are so many; a chunk 64 pixels (3 channels), one row of up to 48
    pixels, or whole short rows."""
    plan = kernels.conv3x3_plan
    assert plan("fprop", 160, 84, 84, 4, 3, 64, 132) == (128, 1, 1, 1)
    assert plan("fprop", 25, 42, 42, 4, 64, 64, 132) == (128, 1, 1, 1)
    assert plan("dgrad", 25, 21, 21, 4, 64, 64, 132) == (128, 1, 1, 1)
    assert plan("fprop", 25, 10, 10, 4, 64, 64, 132) == (64, 1, 1, 1)
    assert plan("dgrad", 160, 10, 10, 4, 64, 64, 132) == (128, 1, 1, 1)
    assert plan("dgrad", 25, 84, 84, 4, 3, 64, 132) == (128, 1, 1, 1)
    # block 0: 64 x 27 outputs a group, 132 splits of the 64-pixel chunks
    assert plan("wgrad", 25, 84, 84, 4, 3, 64, 132) == (0, 132, 1, 1)
    # blocks 1-3: 12 tiles (3 kernel rows x 4 groups), 44 splits, block 3
    # of the support set (63 chunks of 4 rows) 16
    assert plan("wgrad", 160, 42, 42, 4, 64, 64, 132) == (0, 44, 1, 42)
    assert plan("wgrad", 25, 21, 21, 4, 64, 64, 132) == (0, 44, 2, 21)
    assert plan("wgrad", 25, 10, 10, 4, 64, 64, 132) == (0, 16, 4, 10)
    # a row longer than 48 pixels in pieces; few chunks cap the splits
    assert plan("wgrad", 2, 100, 100, 1, 64, 64, 132) == (0, 150, 1, 48)
    assert plan("wgrad", 1, 2, 10, 1, 64, 64, 132) == (0, 1, 4, 10)
    assert plan("wgrad", 1, 1, 1, 1, 3, 4, 132) == (0, 1, 1, 1)


# resnet12.train's 3x3 calls (side, C_in, C_out) at 4 groups, and the wgrad
# plan each gets on 132 SMs at the support set (M=25) and the queries
# (M=160)
RESNET12_WGRAD = {
    (84, 3, 64): ((0, 132, 1, 1), (0, 132, 1, 1)),
    (84, 64, 64): ((0, 44, 1, 48), (0, 168, 1, 48)),
    (42, 64, 160): ((0, 15, 1, 42), (0, 42, 1, 42)),
    (42, 160, 160): ((0, 7, 1, 42), (0, 42, 1, 42)),
    (21, 160, 320): ((0, 3, 2, 21), (0, 11, 2, 21)),
    (21, 320, 320): ((0, 2, 2, 21), (0, 11, 2, 21)),
    (10, 320, 640): ((0, 1, 4, 10), (0, 3, 4, 10)),
    (10, 640, 640): ((0, 1, 4, 10), (0, 3, 4, 10))}


def _resnet12_calls():
    side, cin = 84, 3
    for ch in resnet12.CHANNELS:
        yield side, cin, ch
        yield side, ch, ch
        side, cin = side // 2, ch


@pytest.mark.parametrize("M", [25, 160])
@pytest.mark.parametrize("call", list(_resnet12_calls()),
                         ids=lambda c: f"{c[0]}x{c[0]}-{c[1]}-{c[2]}")
def test_plan_at_resnet12_widths(call, M):
    """ResNet-12's calls at 64-640 channels (160 output channels fill 2.5
    of the 64-wide tiles): 128-pixel fprop and dgrad tiles, every call a
    wave of the card or more; wgrad at least two waves of blocks over its
    tiles (3 kernel rows x 4 groups x 10 x 10 at 640), each split walking
    4 to 160 chunks: the queries' long walks at 64-640 channels split
    further than the waves ask (168 splits at 84x84, 3 at 640 channels)."""
    side, cin, cout = call
    plan = kernels.conv3x3_plan
    for kind in ("fprop", "dgrad"):
        assert plan(kind, M, side, side, 4, cin, cout, 132) == (128, 1, 1, 1)
    got = plan("wgrad", M, side, side, 4, cin, cout, 132)
    assert got == RESNET12_WGRAD[call][M == 160]
    tiles = 4 * (-(-cout // 64)) * (1 if cin <= 3 else 3 * -(-cin // 64))
    assert got.splits * tiles >= 2 * 2 * 132
    chunks = (-(-M * side * side // 64) if cin <= 3 else
              -(-M * side * -(-side // got.piece) // got.rows))
    assert 4 * got.splits <= chunks <= 160 * got.splits


@pytest.mark.parametrize("cin,cout",
                         [(5, 64), (6, 8), (64, 6), (3, 2), (0, 4)])
def test_plan_refuses_what_the_kernels_do_not_take(cin, cout):
    assert not kernels.conv3x3_supported(cin, cout)
    with pytest.raises(ValueError):
        kernels.conv3x3_plan("fprop", 2, 8, 8, 1, cin, cout, 132)
    with pytest.raises(ValueError):
        kernels.conv3x3_plan("wgrad", 2, 8, 8, 1, cin, cout, 132)


@pytest.mark.parametrize("bad", ["kind", "dtype", "devices", "groups",
                                 "kernel", "channels", "wgrad_shape"])
def test_entry_points_refuse_bad_arguments(bad):
    x, w, gy = conv_inputs(2, 2, 4, 4, 6, 6, seed=3, dtype=torch.float32)
    with pytest.raises((ValueError, TypeError)):
        if bad == "kind":
            kernels.conv3x3_plan("conv", 2, 6, 6, 2, 4, 4, 132)
        elif bad == "dtype":
            bf = torch.bfloat16
            kernels.conv3x3_fprop(x.to(bf), w.to(bf), 2)
        elif bad == "devices":
            kernels.conv3x3_fprop(x, w.to(F64), 2)
        elif bad == "groups":
            kernels.conv3x3_fprop(x, w, 3)
        elif bad == "kernel":
            kernels.conv3x3_fprop(x, w[..., :2], 2)
        elif bad == "channels":
            kernels.conv3x3_dgrad(gy[:, :6], w[:6], 2)
        else:
            kernels.conv3x3_wgrad(x, gy[:, :, :5], 2)
