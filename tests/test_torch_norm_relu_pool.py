"""``ops/kernels.py:norm_relu_pool`` on the CPU: its plain versions (the
closed forms the CUDA kernels compute) against autograd of conv4's
written-out chain ``maxpool2x2(relu(batch_stat_norm(z, p)))``, in fp64:
the value, the first gradients, the second-order gradients of an inner SGD
step under ``create_graph=True``, on tied and ReLU-dead windows, and
``gradgradcheck``; conv4's dispatch (the CPU, fp64 and bf16 keep the
written-out chain) and a second-order MAML step through the op. The
kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``)."""

import pytest
import torch

from fumi_tpu_torch.core.episode import Episode
from fumi_tpu_torch.metalearn import inner_loop
from fumi_tpu_torch.models import conv4
from fumi_tpu_torch.ops import kernels

F64 = torch.float64


def chain(z, b, g, be):
    p = {"bias": b, "gamma": g, "beta": be}
    return conv4.maxpool2x2(torch.relu(conv4.batch_stat_norm(z, p, False)))


def inputs(M, G, H, W, seed, dtype=F64):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, dtype=dtype) * scale
                + shift).requires_grad_()
    return (r(M, G, H, W), r(G), r(G, scale=0.3, shift=1.0),
            r(G, scale=0.2))


def tied(M, G, H, W, seed):
    """z whose windows hold exact ties (every window of the first half of
    the channels: its 2x2 copies one value, a second window of the rest
    two) and relu-dead windows (a quarter of the windows sit far below the
    channel's mean)."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn(M, G, H, W, generator=gen, dtype=F64)
    h2, w2 = H // 2, W // 2
    base = torch.randn(M, G, h2, w2, generator=gen, dtype=F64)
    block = base.repeat_interleave(2, 2).repeat_interleave(2, 3)
    z[:, :G // 2, :2 * h2, :2 * w2] = block[:, :G // 2]
    z[:, G // 2:, 0:2 * h2:2, :2 * w2] = block[:, G // 2:, 0::2]
    z[:, :, :2 * h2:4, :2 * w2:4] -= 6.0
    b = torch.randn(G, generator=gen, dtype=F64)
    g = 1.0 + 0.3 * torch.rand(G, generator=gen, dtype=F64)
    be = 0.2 * torch.randn(G, generator=gen, dtype=F64)
    return tuple(t.requires_grad_() for t in (z, b, g, be))


def close(got, want, tol=1e-10):
    scale = max(float(want.detach().abs().max()), 1.0)
    assert float((got - want).detach().abs().max()) <= tol * scale


def second_order(fn, z, b, g, be, seed):
    """Outer gradients to (z, b, γ, β) after one inner SGD step of all four
    under ``create_graph=True``: the support and query losses are tanh of
    the pooled output against fixed weights, so the inner gradient depends
    on the output's cotangent and the outer one reaches every term of the
    double backward."""
    gen = torch.Generator().manual_seed(seed)
    out = fn(z, b, g, be)
    ws = torch.randn(out.shape, generator=gen, dtype=out.dtype)
    wq = torch.randn(out.shape, generator=gen, dtype=out.dtype)
    leaves = (z, b, g, be)
    inner = torch.autograd.grad(torch.tanh(out * ws).sum(), leaves,
                                create_graph=True)
    stepped = [t - 0.1 * d for t, d in zip(leaves, inner)]
    outer = torch.tanh(fn(*stepped) * wq).sum()
    return [outer] + list(torch.autograd.grad(outer, leaves))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("side", [8, 21])
def test_matches_written_out_chain(B, side):
    z, b, g, be = inputs(3, 4 * B, side, side, seed=side + B)
    out = kernels.norm_relu_pool(z, b, g, be)
    want = chain(z, b, g, be)
    assert out.shape == want.shape == (3, 4 * B, side // 2, side // 2)
    close(out, want)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(1),
                      dtype=F64)
    got = torch.autograd.grad((out * cot).sum(), (z, b, g, be))
    ref = torch.autograd.grad((want * cot).sum(), (z, b, g, be))
    for x, y in zip(got, ref):
        close(x, y)
    for x, y in zip(second_order(kernels.norm_relu_pool, z, b, g, be, 2),
                    second_order(chain, z, b, g, be, 2)):
        close(x, y)


@pytest.mark.parametrize("side", [8, 21])
def test_tied_and_dead_windows_split_as_the_chain(side):
    z, b, g, be = tied(2, 6, side, side, seed=side)
    with torch.no_grad():
        stats = kernels.norm_relu_pool_forward_reference(z, b, g, be)[1]
        a = kernels._nrp_normed(z, b, g, be, stats)[1]
        win = kernels._nrp_windows(a).clamp_min(0)
        top = win.amax(dim=(3, 5), keepdim=True)
        ties = ((win == top) & (top > 0)).sum(dim=(3, 5))
    assert int((ties == 4).sum()) > 10 and int((ties == 2).sum()) > 10
    assert int((top == 0).sum()) > 4  # relu-dead windows
    out = kernels.norm_relu_pool(z, b, g, be)
    close(out, chain(z, b, g, be))
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(3),
                      dtype=F64)
    got = torch.autograd.grad((out * cot).sum(), (z, b, g, be))
    ref = torch.autograd.grad((chain(z, b, g, be) * cot).sum(), (z, b, g, be))
    for x, y in zip(got, ref):
        close(x, y)
    for x, y in zip(second_order(kernels.norm_relu_pool, z, b, g, be, 4),
                    second_order(chain, z, b, g, be, 4)):
        close(x, y)


def test_gradgradcheck():
    args = inputs(2, 3, 5, 4, seed=7)
    assert torch.autograd.gradcheck(kernels.norm_relu_pool, args)
    assert torch.autograd.gradgradcheck(kernels.norm_relu_pool, args)


def test_bias_takes_no_gradient():
    """The output does not depend on b (μ takes it away): its gradient and
    its second-order cotangent are exactly 0, where the chain returns its
    rounding residual."""
    z, b, g, be = inputs(2, 4, 8, 8, seed=9)
    grads = second_order(kernels.norm_relu_pool, z, b, g, be, 5)
    assert torch.equal(grads[2], torch.zeros_like(b))
    first = torch.autograd.grad(kernels.norm_relu_pool(z, b, g, be).sum(), b)
    assert torch.equal(first[0], torch.zeros_like(b))


def test_plain_fp32_statistics_near_fp64():
    """In fp32 the plain versions take the statistics in fp64 sums, as the
    kernels do: the output stays within fp32 rounding of the fp64 value."""
    z, b, g, be = inputs(4, 8, 21, 21, seed=11, dtype=torch.float32)
    with torch.no_grad():
        out32 = kernels.norm_relu_pool(z, b, g, be)
        out64 = chain(*(t.double() for t in (z, b, g, be)))
    close(out32.double(), out64, tol=2e-6)


def test_dispatch_keeps_written_out_chain_off_the_card(monkeypatch):
    """The CPU in fp32 and fp64, and bf16, never reach the op: conv_block
    computes what it computed before, bitwise, and launches nothing."""
    calls, op = [], kernels.norm_relu_pool
    before = op.launches
    monkeypatch.setattr(kernels, "norm_relu_pool",
                        lambda *a: calls.append(a))
    gen = torch.Generator().manual_seed(0)
    p = conv4.unit({f"u.{k}": v for k, v in conv4.conv_init(gen, 3, 8).items()},
                   "u", 1)
    y = torch.randn(2, 3, 10, 10, generator=gen).contiguous(
        memory_format=torch.channels_last)
    for dtype, cd in ((torch.float32, None), (F64, None),
                      (torch.float32, torch.bfloat16)):
        pp = {k: v.to(dtype) for k, v in p.items()}
        got = conv4.conv_block(pp, y.to(dtype), cd)
        low = conv4.is_low_precision(cd)
        z = conv4.layers.conv2d_f32acc(y.to(dtype), pp["weight"], cd,
                                       padding=1, keep_dtype=low)
        assert not conv4.fused_norm_applies(z, low)
        want = torch.relu(conv4.batch_stat_norm(z, pp, low))
        want = conv4.maxpool2x2(want.to(cd) if low else want)
        assert torch.equal(got, want)
    assert calls == [] and op.launches == before


def test_maml_second_order_step_through_the_op(monkeypatch):
    """A second-order MAML step through Conv-4 (2 tasks as channel groups,
    2 inner steps, a 20-pixel side so block 2 is odd) with every block on
    the op's plain versions equals the written-out chain's in fp64, and
    calls the op's forward, backward and double backward as often as the
    card launches them: 4 blocks × (3 forwards; 2 inner and 3 outer
    backwards; 2 double backwards)."""
    gen = torch.Generator().manual_seed(0)
    params = {k: v.double() for k, v in
              conv4.init(gen, im_size=20, hidden=6, n_way=3).items()}
    B, S, Q = 2, 6, 9
    x = torch.rand(B, S + Q, 20, 20, 3, generator=gen, dtype=F64)
    y = torch.arange(3).repeat(B, (S + Q) // 3)
    episode = Episode(support_im=x[:, :S], support_text=None,
                      support_text_mask=None, support_ids=None,
                      support_y=y[:, :S], query_im=x[:, S:], query_ids=None,
                      query_y=y[:, S:])

    def step():
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss, _ = inner_loop.maml_episode_loss(
            conv4.apply, leaves, episode, n_steps=2, step_size=0.1,
            first_order=False)
        return [loss] + list(torch.autograd.grad(loss, list(leaves.values())))

    want = step()
    counts = {"_nrp_forward": 0, "_nrp_backward": 0,
              "_nrp_double_backward": 0}
    for name in counts:
        def counted(*a, _fn=getattr(kernels, name), _name=name):
            counts[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(kernels, name, counted)
    monkeypatch.setattr(conv4, "fused_norm_applies", lambda z, low: not low)
    got = step()
    assert counts == {"_nrp_forward": 12, "_nrp_backward": 20,
                      "_nrp_double_backward": 8}
    for k, (a, b) in zip(["loss"] + list(params), zip(got, want)):
        if k.endswith(".bias") and k.startswith("convs"):
            # the chain's residual, the op's exact 0
            assert float(a.abs().max()) == 0.0
            assert float(b.abs().max()) < 1e-12
            continue
        close(a, b, tol=1e-9)


def test_plan():
    assert kernels.norm_relu_pool_plan(256, True, 132) == (4, 64, 528)
    assert kernels.norm_relu_pool_plan(192, True, 132) == (4, 48, 528)
    assert kernels.norm_relu_pool_plan(2048, True, 132) == (4, 64, 66)
    assert kernels.norm_relu_pool_plan(256, False, 132) == (1, 64, 132)
    assert kernels.norm_relu_pool_plan(6, True, 132) == (1, 6, 528)


@pytest.mark.parametrize("bad", ["shape", "side", "dtype", "param"])
def test_refuses_what_the_kernels_do_not_take(bad):
    z, b, g, be = inputs(2, 4, 8, 8, seed=0)
    if bad == "shape":
        z = z[0]
    elif bad == "side":
        z = z[:, :, :1]
    elif bad == "dtype":
        z = z.to(torch.bfloat16)
    else:
        g = g[:3]
    with pytest.raises((ValueError, TypeError)):
        kernels.norm_relu_pool(z, b, g, be)
