"""``ops/kernels.py:norm_relu_pool`` and its leaky forms on the CPU: the
plain versions (the closed forms the CUDA kernels compute) against
autograd of the written-out chains in fp64, conv4's
``maxpool2x2(relu(batch_stat_norm(z, p)))`` and resnet12's
``leaky_relu(batch_stat_norm(z, p), 0.1)`` (units c1 and c2) and
``maxpool2x2(leaky_relu(batch_stat_norm(z, p) + batch_stat_norm(z_sc,
p_sc), 0.1))`` (unit c3 and the shortcut): the value, the first gradients,
the second-order gradients of an inner SGD step under
``create_graph=True``, on tied, negative and ReLU-dead windows and a = 0,
and ``gradgradcheck``; conv4's form bitwise the plain versions it had
before the leaky forms; conv4's and resnet12's dispatch (the CPU, fp64 and
bf16 keep the written-out chains) and a second-order MAML step through
conv4's (resnet12's runs in ``tests/test_torch_bench_maml_resnet12.py``).
The kernels themselves are held against the plain versions on the
card (``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from fumi_tpu_torch.core.episode import Episode
from fumi_tpu_torch.metalearn import inner_loop
from fumi_tpu_torch.models import conv4, resnet12
from fumi_tpu_torch.ops import kernels

F64 = torch.float64


def norm(z, b, g, be):
    return conv4.batch_stat_norm(z, {"bias": b, "gamma": g, "beta": be},
                                 False)


def chain(z, b, g, be):
    return conv4.maxpool2x2(torch.relu(norm(z, b, g, be)))


def chain_leaky(z, b, g, be):
    return F.leaky_relu(norm(z, b, g, be), resnet12.LEAK)


def chain_residual(z, b, g, be, zs, bs, gs, bes):
    return conv4.maxpool2x2(F.leaky_relu(
        norm(z, b, g, be) + norm(zs, bs, gs, bes), resnet12.LEAK))


# each form: its op, the chain it computes, its kernels.NormForm
FORMS = {"relu_pool": (kernels.norm_relu_pool, chain, kernels.RELU_POOL),
         "leaky": (kernels.norm_leaky_relu, chain_leaky, kernels.LEAKY),
         "residual": (kernels.norm_residual_pool, chain_residual,
                      kernels.LEAKY_SUM_POOL)}


def cases(*params):
    """Every form at each of ``params``: conv4's cases keep the ids they
    had before the leaky forms, the others' start with the form's name."""
    out = []
    for form in FORMS:
        for p in params:
            p = p if isinstance(p, tuple) else (p,)
            ids = [str(x) for x in reversed(p)]
            out.append(pytest.param(form, *p, id="-".join(
                ids if form == "relu_pool" else [form] + ids)))
    return out


def inputs(M, G, H, W, seed, dtype=F64, branches=1):
    """(z, b, γ, β) of each branch, flat."""
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, dtype=dtype) * scale
                + shift).requires_grad_()
    return sum(((r(M, G, H, W), r(G), r(G, scale=0.3, shift=1.0),
                 r(G, scale=0.2)) for _ in range(branches)), ())


def tied(M, G, H, W, seed, branches=1):
    """z whose windows hold exact ties (every window of the first half of
    the channels: its 2x2 copies one value, a second window of the rest
    two; the same positions in every branch, so their sum ties too),
    relu-dead and negative windows (a quarter of the windows sit far below
    the channel's mean), and a = 0 at every position of the last channel
    (γ = β = 0 there)."""
    gen = torch.Generator().manual_seed(seed)
    out = ()
    for _ in range(branches):
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
        g[-1] = be[-1] = 0.0
        out += tuple(t.requires_grad_() for t in (z, b, g, be))
    return out


def close(got, want, tol=1e-10):
    scale = max(float(want.detach().abs().max()), 1.0)
    assert float((got - want).detach().abs().max()) <= tol * scale


def second_order(fn, leaves, seed):
    """Outer gradients to the leaves (z, b, γ, β of each branch) after one
    inner SGD step of all of them under ``create_graph=True``: the support
    and query losses are tanh of the output against fixed weights, so the
    inner gradient depends on the output's cotangent and the outer one
    reaches every term of the double backward."""
    gen = torch.Generator().manual_seed(seed)
    out = fn(*leaves)
    ws = torch.randn(out.shape, generator=gen, dtype=out.dtype)
    wq = torch.randn(out.shape, generator=gen, dtype=out.dtype)
    inner = torch.autograd.grad(torch.tanh(out * ws).sum(), leaves,
                                create_graph=True)
    stepped = [t - 0.1 * d for t, d in zip(leaves, inner)]
    outer = torch.tanh(fn(*stepped) * wq).sum()
    return [outer] + list(torch.autograd.grad(outer, leaves))


@pytest.mark.parametrize("form,B,side", cases((1, 8), (1, 21), (3, 8),
                                             (3, 21)))
def test_matches_written_out_chain(form, B, side):
    op, want_fn, kform = FORMS[form]
    leaves = inputs(3, 4 * B, side, side, seed=side + B,
                    branches=kform.branches)
    out = op(*leaves)
    want = want_fn(*leaves)
    pooled = side // 2 if kform.pool else side
    assert out.shape == want.shape == (3, 4 * B, pooled, pooled)
    close(out, want)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(1),
                      dtype=F64)
    got = torch.autograd.grad((out * cot).sum(), leaves)
    ref = torch.autograd.grad((want * cot).sum(), leaves)
    for x, y in zip(got, ref):
        close(x, y)
    for x, y in zip(second_order(op, leaves, 2),
                    second_order(want_fn, leaves, 2)):
        close(x, y)


@pytest.mark.parametrize("form,side", cases(8, 21))
def test_tied_and_dead_windows_split_as_the_chain(form, side):
    op, want_fn, kform = FORMS[form]
    leaves = tied(2, 6, side, side, seed=side, branches=kform.branches)
    with torch.no_grad():
        stats = kernels.norm_relu_pool_forward_reference(kform, leaves)[1]
        a = kernels._nrp_summed(leaves, stats)[1]
        win = kernels._nrp_windows(a)
        top = win.amax(dim=(3, 5), keepdim=True)
        ties = ((win == top) & (top > 0)).sum(dim=(3, 5))
        low_ties = ((win == top) & (top < 0)).sum(dim=(3, 5))
    assert int((ties == 4).sum()) > 10 and int((ties == 2).sum()) > 10
    assert int((low_ties == 4).sum()) > 10  # negative (relu-dead) ties
    assert int((top <= 0).sum()) > 4  # relu-dead windows
    assert not a[:, -1].any()  # a = 0
    out = op(*leaves)
    close(out, want_fn(*leaves))
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(3),
                      dtype=F64)
    got = torch.autograd.grad((out * cot).sum(), leaves)
    ref = torch.autograd.grad((want_fn(*leaves) * cot).sum(), leaves)
    for x, y in zip(got, ref):
        close(x, y)
    for x, y in zip(second_order(op, leaves, 4),
                    second_order(want_fn, leaves, 4)):
        close(x, y)


def test_gradgradcheck():
    """Every form, at a tiny shape with an odd side."""
    for op, _, kform in FORMS.values():
        args = inputs(2, 3, 5, 4, seed=7, branches=kform.branches)
        assert torch.autograd.gradcheck(op, args)
        assert torch.autograd.gradgradcheck(op, args)


def test_bias_takes_no_gradient():
    """The output does not depend on any branch's b (μ takes it away): its
    gradient and its second-order cotangent are exactly 0, where the chain
    returns its rounding residual."""
    for op, _, kform in FORMS.values():
        leaves = inputs(2, 4, 8, 8, seed=9, branches=kform.branches)
        grads = second_order(op, leaves, 5)
        first = torch.autograd.grad(op(*leaves).sum(), leaves[1::4])
        for k, b in enumerate(leaves[1::4]):
            assert torch.equal(grads[2 + 4 * k], torch.zeros_like(b))
            assert torch.equal(first[k], torch.zeros_like(b))


def test_plain_fp32_statistics_near_fp64():
    """In fp32 the plain versions take the statistics in fp64 sums, as the
    kernels do: each form's output stays within fp32 rounding of the fp64
    value."""
    for op, want_fn, kform in FORMS.values():
        leaves = inputs(4, 8, 21, 21, seed=11, dtype=torch.float32,
                        branches=kform.branches)
        with torch.no_grad():
            out32 = op(*leaves)
            out64 = want_fn(*(t.double() for t in leaves))
        close(out32.double(), out64, tol=2e-6)


def _parent_forward(z, bias, gamma, beta):
    """conv4's plain forward as it was before the leaky forms (a frozen
    copy: :func:`test_relu_pool_form_equals_its_former_plain_versions`)."""
    ch, win = kernels._nrp_chan, kernels._nrp_windows
    M, G, H, W = z.shape
    y = z + ch(bias)
    shift = y[0, :, 0, 0].to(F64)
    d = y.to(F64) - ch(shift)
    n = M * H * W
    mean = d.sum(dim=(0, 2, 3)) / n
    var = (d.square().sum(dim=(0, 2, 3)) / n - mean.square()).clamp_min(0.0)
    eps = torch.tensor(kernels.NORM_EPS, dtype=z.dtype).item()
    stats = torch.stack([shift + mean, torch.rsqrt(var + eps)]).to(z.dtype)
    a = _parent_normed(z, bias, gamma, beta, stats)[1]
    return win(a.clamp_min(0.0)).amax(dim=(3, 5)), stats


def _parent_normed(z, bias, gamma, beta, stats):
    ch = kernels._nrp_chan
    x = (z + ch(bias) - ch(stats[0])) * ch(stats[1])
    return x, x * ch(gamma) + ch(beta)


def _parent_route(a, g_out):
    M, G, H, W = a.shape
    win = kernels._nrp_windows(a)
    h = win.clamp_min(0)
    tie = h == h.amax(dim=(3, 5), keepdim=True)
    ties = tie.sum(dim=(3, 5), keepdim=True).to(a.dtype)
    routed = tie & (win > 0)
    share = g_out.reshape(win.shape[:3] + (1, win.shape[4], 1)) / ties
    ga = torch.where(routed, share, 0.0).reshape(
        M, G, 2 * win.shape[2], 2 * win.shape[4])
    return F.pad(ga, (0, W - ga.shape[3], 0, H - ga.shape[2])), routed, ties


def _parent_backward(z, bias, gamma, beta, stats, g_out):
    ch, sums = kernels._nrp_chan, kernels._nrp_sums
    M, G, H, W = z.shape
    n = M * H * W
    x, a = _parent_normed(z, bias, gamma, beta, stats)
    ga = _parent_route(a, g_out)[0]
    A, S = sums(ga), sums(ga, x)
    gr = gamma.to(F64) * stats[1].to(F64)
    k1, k2, k3 = (ch(k.to(z.dtype)) for k in (gr, -gr * S / n, -gr * A / n))
    return (k1 * ga + k2 * x + k3, torch.zeros_like(bias), S.to(z.dtype),
            A.to(z.dtype), torch.stack([A, S]))


def _parent_double_backward(z, bias, gamma, beta, stats, g_out, sums, v_z,
                            v_gamma, v_beta):
    ch, win, tot = kernels._nrp_chan, kernels._nrp_windows, kernels._nrp_sums
    M, G, H, W = z.shape
    n = M * H * W
    x, a = _parent_normed(z, bias, gamma, beta, stats)
    ga, routed, ties = _parent_route(a, g_out)
    Vs, VX, VG = tot(v_z), tot(v_z, x), tot(v_z, ga)
    A, S = sums[0], sums[1]
    r, g = stats[1].to(F64), gamma.to(F64)
    gr = g * r
    vg, vb = v_gamma.to(F64), v_beta.to(F64)
    qq = VG - A * Vs / n - S * VX / n
    mean_p = -gr * (A * VX + Vs * S) / n ** 2 + vg * A / n
    mean_px = -2.0 * gr * S * VX / n ** 2 + vg * S / n
    ag, av, ax, a0, wv, wx, w0 = (
        ch(k.to(z.dtype)) for k in (
            r * (vg - gr * VX / n), -gr * r * S / n,
            -r * mean_px - g * qq * r * r / n, -r * mean_p, gr,
            vg - gr * VX / n, vb - gr * Vs / n))
    c_z = ag * ga + av * v_z + ax * x + a0
    w = win(wv * v_z + wx * x + w0)
    c_gout = torch.where(routed, w, 0.0).sum(dim=(3, 5)) / ties[:, :, :, 0, :, 0]
    return (c_z, torch.zeros_like(bias), (r * qq).to(z.dtype),
            torch.zeros_like(beta), c_gout)


@pytest.mark.parametrize("dtype", [F64, torch.float32],
                         ids=["fp64", "fp32"])
def test_relu_pool_form_equals_its_former_plain_versions(dtype):
    """conv4's form of the plain versions, on tied and on random windows,
    gives bitwise what they gave before the leaky forms: the forward, the
    backward and the double backward."""
    gen = torch.Generator().manual_seed(13)
    for leaves in (tied(2, 6, 9, 9, seed=5),
                   inputs(3, 8, 10, 10, seed=6, dtype=dtype)):
        z, b, g, be = (t.detach().to(dtype) for t in leaves)
        out, stats = kernels.norm_relu_pool_forward_reference(
            kernels.RELU_POOL, (z, b, g, be))
        want = _parent_forward(z, b, g, be)
        g_out = torch.randn(out.shape, generator=gen, dtype=F64).to(dtype)
        grads, sums = kernels.norm_relu_pool_backward_reference(
            kernels.RELU_POOL, (z, b, g, be), stats, g_out)
        want += _parent_backward(z, b, g, be, stats, g_out)
        v = [torch.randn(t.shape, generator=gen, dtype=F64).to(dtype)
             for t in (z, g, be)]
        cs, c_gout = kernels.norm_relu_pool_double_backward_reference(
            kernels.RELU_POOL, (z, b, g, be), stats, g_out, sums,
            (v[0], None, v[1], v[2]))
        want += _parent_double_backward(z, b, g, be, stats, g_out, sums, *v)
        got = (out, stats) + grads + (sums,) + cs + (c_gout,)
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_dispatch_keeps_written_out_chain_off_the_card(monkeypatch):
    """The CPU in fp32 and fp64, and bf16, never reach the ops: conv4's
    conv_block and resnet12's res_block compute what they computed before,
    bitwise, and launch nothing."""
    calls, ops = [], [FORMS[f][0] for f in FORMS]
    before = [op.launches for op in ops]
    for name in ("norm_relu_pool", "norm_leaky_relu", "norm_residual_pool"):
        monkeypatch.setattr(kernels, name, lambda *a: calls.append(a))
    gen = torch.Generator().manual_seed(0)
    p = conv4.unit({f"u.{k}": v for k, v in conv4.conv_init(gen, 3, 8).items()},
                   "u", 1)
    rp = {f"s.{k}": v for k, v in resnet12.block_init(gen, 3, 8).items()}
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

        # resnet12: 3×[conv-norm(-leaky)] + projected shortcut → leaky → pool
        rpp = {k: v.to(dtype) for k, v in rp.items()}

        def cb(u, t):
            q = conv4.unit(rpp, f"s.{u}", 1)
            z = conv4.layers.conv2d_f32acc(
                t, q["weight"], cd, padding=q["weight"].shape[-1] // 2,
                keep_dtype=low)
            z = conv4.batch_stat_norm(z, q, low)
            return z.to(cd) if low else z
        t = F.leaky_relu(cb("c1", y.to(dtype)), resnet12.LEAK)
        t = F.leaky_relu(cb("c2", t), resnet12.LEAK)
        t = cb("c3", t) + cb("sc", y.to(dtype))
        want = conv4.maxpool2x2(F.leaky_relu(t, resnet12.LEAK))
        assert torch.equal(resnet12.res_block(rpp, "s", y.to(dtype), 1, cd),
                           want)
    assert calls == [] and [op.launches for op in ops] == before


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


@pytest.mark.parametrize("bad", ["shape", "side", "dtype", "param",
                                 "branch"])
def test_refuses_what_the_kernels_do_not_take(bad):
    z, b, g, be = inputs(2, 4, 8, 8, seed=0)
    if bad == "branch":
        with pytest.raises(ValueError):
            kernels.norm_residual_pool(z, b, g, be, z[:, :, :6], b, g, be)
        return
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
