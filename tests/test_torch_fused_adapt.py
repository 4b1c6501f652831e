"""The port's fused test-time adaptation against the JAX package's.

``fused_adapt_reference`` (the plain PyTorch version of the CUDA kernel)
is held against the Pallas kernel run in interpret mode on the CPU, and
against a plain autograd SGD loop. The CUDA kernel itself is held against
the reference on the card by ``tests/test_torch_cuda.py``, and timed
alone by ``scripts/kernel_times.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fumi_tpu.models import mlp as jax_mlp
from fumi_tpu.models import text_encoders as jax_te
from fumi_tpu.models.fumi import FUMI as JaxFUMI
from fumi_tpu.ops import pallas_kernels as pk
from fumi_tpu_torch import bridge
from fumi_tpu_torch.models import mlp
from fumi_tpu_torch.ops import fewshot, kernels

B, N, K, QN, D, H, E = 2, 3, 2, 4, 16, (8, 8), 8
STEPS, STEP = 10, 0.1
TOL = dict(rtol=2e-5, atol=2e-5)  # the tolerance tests/test_pallas.py holds


def episodes(seed):
    rng = np.random.RandomState(seed)
    sx = rng.randn(B, N * K, D).astype(np.float32)
    qx = rng.randn(B, N * QN, D).astype(np.float32)
    sy = np.tile(np.repeat(np.arange(N), K), (B, 1)).astype(np.int32)
    return sx, sy, qx


def t(x):
    return torch.from_numpy(np.array(x))


def jax_fumi():
    enc = jax_te.make_text_encoder("precomputed", jax.random.PRNGKey(1), E)
    model = JaxFUMI(n_way=N, im_emb_dim=D, im_hid_dim=H, text_encoder=enc,
                    text_emb_dim=E, text_hid_dim=8, dropout_rate=0.0,
                    norm_hypernet=True, fine_tune=False, init_bias=False)
    return model, model.init_params(jax.random.PRNGKey(0))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_reference_matches_jax_fused_maml():
    params = jax_mlp.init(jax.random.PRNGKey(0), D, N, H)
    sx, sy, qx = episodes(0)
    want = pk.fused_maml_adapt(params, jnp.asarray(sx), jnp.asarray(sy),
                               jnp.asarray(qx), STEPS, STEP, interpret=True)
    p = bridge.params_from_jax(np_tree(params), "maml", device="cpu")
    got = kernels.fused_maml_adapt(p, t(sx), t(sy), t(qx), STEPS, STEP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reference_matches_jax_fused_fumi():
    model, params = jax_fumi()
    sx, sy, qx = episodes(1)
    st = np.random.RandomState(2).randn(B, N * K, E).astype(np.float32)
    hyper0 = jax.vmap(lambda a, b: model.get_hyper_params(
        params, a, b, rng=jax.random.PRNGKey(0)))(jnp.asarray(st),
                                                   jnp.asarray(sy))
    want = pk.fused_fumi_adapt(params["im_net"], hyper0, jnp.asarray(sx),
                               jnp.asarray(sy), jnp.asarray(qx), STEPS, STEP,
                               interpret=True)
    p = bridge.params_from_jax(np_tree(params), "fumi", device="cpu")
    got = kernels.fused_fumi_adapt(p, t(np.asarray(hyper0)), t(sx), t(sy),
                                   t(qx), STEPS, STEP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("per_task_head", [False, True])
def test_reference_matches_autograd_sgd(per_task_head):
    """The hand-derived backward equals autograd's on the same loop."""
    gen = torch.Generator().manual_seed(3)
    p = mlp.init(gen, D, N, H)
    sx, sy, qx = (t(a) for a in episodes(3))
    head_w = p["net.lin_final.weight"].expand(B, N, H[1]).clone()
    head_b = p["net.lin_final.bias"].expand(B, 1, N).clone()
    if per_task_head:
        head_w = head_w + 0.1 * torch.randn(head_w.shape, generator=gen)
        head_b = head_b + 0.1 * torch.randn(head_b.shape, generator=gen)
    got = kernels.fused_adapt_reference(
        p["net.lin_0.weight"], p["net.lin_0.bias"], p["net.lin_1.weight"],
        p["net.lin_1.bias"], head_w, head_b, sx, sy, qx, STEPS, STEP)

    want = []
    for b in range(B):
        q = {k: v.clone() for k, v in p.items()}
        q["net.lin_final.weight"] = head_w[b].clone()
        q["net.lin_final.bias"] = head_b[b, 0].clone()
        for _ in range(STEPS):
            leaves = {k: v.requires_grad_() for k, v in q.items()}
            loss = fewshot.cross_entropy(mlp.apply(leaves, sx[b]), sy[b])
            grads = torch.autograd.grad(loss, list(leaves.values()))
            q = {k: (v - STEP * g).detach()
                 for (k, v), g in zip(leaves.items(), grads)}
        want.append(mlp.apply(q, qx[b]))
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(), **TOL)


def test_wrapper_on_cpu_is_the_reference():
    gen = torch.Generator().manual_seed(4)
    p = mlp.init(gen, D, N, H)
    sx, sy, qx = (t(a) for a in episodes(4))
    before = kernels.fused_adapt.launches
    a = kernels.fused_maml_adapt(p, sx, sy, qx, STEPS, STEP)
    head_w = p["net.lin_final.weight"].expand(B, N, H[1]).contiguous()
    head_b = p["net.lin_final.bias"].expand(B, 1, N).contiguous()
    b = kernels.fused_adapt_reference(
        p["net.lin_0.weight"], p["net.lin_0.bias"], p["net.lin_1.weight"],
        p["net.lin_1.bias"], head_w, head_b, sx, sy, qx, STEPS, STEP)
    assert torch.equal(a, b)
    assert kernels.fused_adapt.launches == before  # no kernel on the CPU


def test_reference_in_fp64_is_the_same_loop():
    """The fp64 evaluation (the accuracy yardstick on the card) runs the
    same loop; the wrapper itself takes fp32 only."""
    gen = torch.Generator().manual_seed(9)
    p = mlp.init(gen, D, N, H)
    sx, sy, qx = (t(a) for a in episodes(9))
    args = (p["net.lin_0.weight"], p["net.lin_0.bias"],
            p["net.lin_1.weight"], p["net.lin_1.bias"],
            p["net.lin_final.weight"].expand(B, N, H[1]).contiguous(),
            p["net.lin_final.bias"].expand(B, 1, N).contiguous(), sx, sy, qx)
    f32 = kernels.fused_adapt_reference(*args, STEPS, STEP)
    wide = tuple(a if a.dtype == torch.int32 else a.double() for a in args)
    f64 = kernels.fused_adapt_reference(*wide, STEPS, STEP)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(f32.numpy(), f64.numpy(), **TOL)
    with pytest.raises(TypeError):
        kernels.fused_adapt(*wide, STEPS, STEP)


@pytest.mark.parametrize("family", ["maml", "fumi"])
def test_rejects_wrong_depth(family):
    sx, sy, qx = (t(a) for a in episodes(5))
    gen = torch.Generator().manual_seed(0)
    if family == "maml":
        with pytest.raises(ValueError):
            kernels.fused_maml_adapt(mlp.init(gen, D, N, (8,)), sx, sy, qx,
                                     1, STEP)
    else:
        im = {"im_net.linear0.weight": torch.zeros(8, D),
              "im_net.linear0.bias": torch.zeros(8)}
        with pytest.raises(ValueError):
            kernels.fused_fumi_adapt(im, torch.zeros(B, N, 9), sx, sy, qx,
                                     1, STEP)


@pytest.mark.parametrize("bad", ["support_x", "w1", "head_w", "labels"])
def test_rejects_wrong_dtype(bad):
    gen = torch.Generator().manual_seed(0)
    p = mlp.init(gen, D, N, H)
    sx, sy, qx = (t(a) for a in episodes(6))
    args = dict(w1=p["net.lin_0.weight"], b1=p["net.lin_0.bias"],
                w2=p["net.lin_1.weight"], b2=p["net.lin_1.bias"],
                head_w=torch.zeros(B, N, H[1]), head_b=torch.zeros(B, 1, N),
                support_x=sx, support_y=sy, query_x=qx)
    if bad == "labels":
        args["support_y"] = sy.long()
    else:
        args[bad] = args[bad].double()
    with pytest.raises(TypeError):
        kernels.fused_adapt(n_steps=1, step_size=STEP, **args)


def test_rejects_wrong_shape():
    gen = torch.Generator().manual_seed(0)
    p = mlp.init(gen, D, N, H)
    sx, sy, qx = (t(a) for a in episodes(7))
    with pytest.raises(ValueError):
        kernels.fused_adapt(p["net.lin_0.weight"], p["net.lin_0.bias"],
                            p["net.lin_1.weight"], p["net.lin_1.bias"],
                            torch.zeros(B, N, H[1] + 1),
                            torch.zeros(B, 1, N), sx, sy, qx, 1, STEP)


def test_gate():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    least = kernels.MIN_FUSED_STEPS  # the crossover measured on the card
    assert kernels.fused_adapt_supported((256, 64), 100, cuda)
    assert not kernels.fused_adapt_supported((256, 64), 100, cpu)
    assert not kernels.fused_adapt_supported((256,), 100, cuda)
    assert kernels.fused_adapt_supported((256, 64), least, cuda)
    assert not kernels.fused_adapt_supported((256, 64), least - 1, cuda)
    assert kernels.fused_adapt_applicable("fumi", "precomputed", (256, 64),
                                          least, cuda)
    assert not kernels.fused_adapt_applicable("am3", "precomputed",
                                              (256, 64), 100, cuda)
    assert not kernels.fused_adapt_applicable("maml", "conv4", (256, 64),
                                              100, cuda)


# ---------------------------------------------------------------------------
# The Gram form the CUDA kernel adapts in (csrc/fused_adapt.cu): W1 never
# formed, its change carried as P, the sum of the steps' dr1
# ---------------------------------------------------------------------------

def gram_form(w1, b1, w2, b2, head_w, head_b, sx, sy, qx, n_steps, step,
              wide=None):
    """``fused_adapt_reference``'s function in the kernel's algebra:
    W1_t = W1_0 - step * P^T X, so the support rows' layer 1 is
    X W1_0^T - step * G P (G = X X^T) and the queries' Q W1_0^T -
    step * (Q X^T) P. ``wide`` is the dtype of G, Q X^T, P and the two
    corrections (the inputs' by default); the rest is the inputs' dtype."""
    dt = sx.dtype
    wide = wide or dt
    B, S, _ = sx.shape
    N = head_w.shape[1]
    y1h = (sy.unsqueeze(-1) == torch.arange(N)).to(dt)
    xw = sx.to(wide)
    A0 = torch.matmul(sx, w1.mT)
    G = torch.matmul(xw, xw.mT)
    P = torch.zeros(A0.shape, dtype=wide)
    c1 = b1.expand(B, -1).clone()
    W2 = w2.expand(B, -1, -1).clone()
    c2 = b2.expand(B, -1).clone()
    W3 = head_w.clone()
    c3 = head_b.reshape(B, N).clone()

    def rest(a1):
        r1 = torch.relu(a1)
        a2 = torch.matmul(r1, W2.mT) + c2.unsqueeze(1)
        r2 = torch.relu(a2)
        return r1, a2, r2, torch.matmul(r2, W3.mT) + c3.unsqueeze(1)

    for _ in range(n_steps):
        a1 = (A0.to(wide) - step * torch.matmul(G, P)).to(dt) \
            + c1.unsqueeze(1)
        r1, a2, r2, logits = rest(a1)
        g = (torch.softmax(logits, dim=-1) - y1h) / float(S)
        dr2 = torch.where(a2 > 0, torch.matmul(g, W3), 0.0)
        dr1 = torch.where(a1 > 0, torch.matmul(dr2, W2), 0.0)
        P = P + dr1.to(wide)
        W3 = W3 - step * torch.matmul(g.mT, r2)
        W2 = W2 - step * torch.matmul(dr2.mT, r1)
        c1 = c1 - step * dr1.sum(dim=1)
        c2 = c2 - step * dr2.sum(dim=1)
        c3 = c3 - step * g.sum(dim=1)
    qxw = torch.matmul(qx.to(wide), xw.mT)
    a1q = (torch.matmul(qx, w1.mT).to(wide)
           - step * torch.matmul(qxw, P)).to(dt) + c1.unsqueeze(1)
    return rest(a1q)[-1]


def gram_args(shape, head, seed):
    """fp64 inputs: ``shape`` "base" is this file's episodes, "ragged" 10
    support rows over D=16 (S > D/2) and 7 queries; ``head`` "per_task" or
    "shared" (one head at a task stride of 0)."""
    gen = torch.Generator().manual_seed(seed)
    n, k, qn = (N, K, QN) if shape == "base" else (5, 2, 7)
    p = mlp.init(gen, D, n, H)
    sx = torch.randn(B, n * k, D, generator=gen)
    qx = torch.randn(B, qn, D, generator=gen)
    sy = torch.arange(n, dtype=torch.int32).repeat_interleave(k).repeat(B, 1)
    if head == "shared":
        head_w = p["net.lin_final.weight"].expand(B, n, H[1])
        head_b = p["net.lin_final.bias"].expand(B, 1, n)
    else:
        head_w = 0.3 * torch.randn(B, n, H[1], generator=gen)
        head_b = 0.3 * torch.randn(B, 1, n, generator=gen)
    args = (p["net.lin_0.weight"], p["net.lin_0.bias"], p["net.lin_1.weight"],
            p["net.lin_1.bias"], head_w, head_b, sx, sy, qx)
    return tuple(a if a.dtype == torch.int32 else a.double() for a in args)


@pytest.mark.parametrize("shape", ["base", "ragged"])
@pytest.mark.parametrize("head", ["per_task", "shared"])
@pytest.mark.parametrize("n_steps", [0, 1, 10, 100])
def test_gram_form_is_the_reference_loop(shape, head, n_steps):
    """The identity the kernel rests on: in fp64 the Gram form is
    ``fused_adapt_reference``'s loop to 1e-9."""
    args = gram_args(shape, head, 20 + n_steps)
    want = kernels.fused_adapt_reference(*args, n_steps, STEP)
    got = gram_form(*args, n_steps, STEP)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("head", ["per_task", "shared"])
def test_gram_form_in_fp32_with_fp64_corrections(head):
    """The kernel's precision: fp32 inputs and layers, G, Q X^T, P and the
    corrections in fp64; within the module's tolerance of the fp32 loop
    at 10 steps."""
    args = tuple(a if a.dtype == torch.int32 else a.float()
                 for a in gram_args("base", head, 7))
    want = kernels.fused_adapt_reference(*args, STEPS, STEP)
    got = gram_form(*args, STEPS, STEP, wide=torch.float64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ---------------------------------------------------------------------------
# The kernel's launch plan (pure Python; the card checks it against the
# source's layout in tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

H100_SMEM, H100_CLUSTER = 232_448, 16  # what an H100 reports


def test_plan_flagship():
    """A 16-block cluster a task, 128 columns of D a block, W1 tiles of 32
    rows, everything in shared memory: B does not change the plan."""
    for b in (1, 4, 16):
        plan = kernels.fused_adapt_plan((b, 25, 100, 2048, 256, 64, 5),
                                        H100_SMEM, H100_CLUSTER)
        assert (plan.C, plan.cols, plan.tile_k) == (16, 128, 32)
        assert plan.private == "shared"
        assert plan.smem_bytes <= H100_SMEM
    # the served bucket of 128 queries takes the same plan
    assert kernels.fused_adapt_plan((1, 25, 128, 2048, 256, 64, 5),
                                    H100_SMEM, H100_CLUSTER) == plan


@pytest.mark.parametrize("D, C, cols", [(16, 1, 16), (64, 2, 32),
                                        (300, 9, 34), (2049, 16, 129)])
def test_plan_small_and_ragged_D(D, C, cols):
    """Small D takes a smaller cluster (at least 32 columns a block);
    where C does not divide D the last block owns fewer columns."""
    plan = kernels.fused_adapt_plan((2, 25, 50, D, 64, 16, 5), H100_SMEM,
                                    H100_CLUSTER)
    assert (plan.C, plan.cols, plan.tile_k) == (C, cols, 32)
    assert 0 < D - (C - 1) * cols <= cols


def test_plan_follows_the_card():
    """A card that schedules clusters of 8 at most gets C=8; one with less
    shared memory gets shallower W1 tiles, each row of depth less taking
    a row of each of the two tile buffers off the plan's bytes; D=4096
    fits an H100 with the flagship's cluster, and so do 64 support rows
    with tiles of 8 rows, and 2048 hidden units over 5 rows with query
    chunks of 8."""
    dims = (4, 25, 100, 2048, 256, 64, 5)
    assert kernels.fused_adapt_plan(dims, H100_SMEM, 8).C == 8
    deep = kernels.fused_adapt_plan(dims, H100_SMEM, H100_CLUSTER)
    small = kernels.fused_adapt_plan(dims, 140_000, H100_CLUSTER)
    assert (small.C, small.cols, small.tile_k) == (16, 128, 16)
    assert small.smem_bytes <= 140_000
    row = 4 * (256 + 4)  # a tile row of the flagship's 256 hidden columns
    assert deep.smem_bytes - small.smem_bytes == 2 * 16 * row
    assert kernels.fused_adapt_plan((2, 25, 50, 4096, 256, 64, 5), H100_SMEM,
                                    H100_CLUSTER)[:3] == (16, 256, 32)
    assert kernels.fused_adapt_plan((1, 64, 100, 2048, 256, 64, 10),
                                    H100_SMEM, H100_CLUSTER).tile_k == 8
    # 2048 hidden units over 5 support rows: query chunks of the 8 support
    # rows' size fit where chunks of 32 do not
    wide = kernels.fused_adapt_plan((1, 5, 100, 2048, 2048, 64, 5),
                                    H100_SMEM, H100_CLUSTER)
    assert (wide.tile_k, wide.query_rows, wide.private) == (32, 8, "shared")
    assert deep.query_rows == kernels.QUERY_ROWS


@pytest.mark.parametrize("dims, match", [
    ((1, 32, 32, 64, 2048, 16, 3),
     r"S=32 Qn=32 D=64 H1=2048 H2=16 N=3.*shared memory"),
    ((1, 64, 32, 4096, 256, 4096, 5),
     r"S=64 Qn=32 D=4096 H1=256 H2=4096 N=5.*shared memory")])
def test_plan_raises_where_nothing_fits(dims, match):
    """32 support rows of 2048 hidden units at D=64 (a cluster of 2): the
    partial sums of 1024 columns a block exceed its shared memory; so do
    64 rows of a 4096-wide relu(a2), which every block receives; neither
    goes to device memory, since the cluster's blocks write them."""
    with pytest.raises(RuntimeError, match=match):
        kernels.fused_adapt_plan(dims, H100_SMEM, H100_CLUSTER)


# (B, S, Qn, D, H1, H2, N), where: wide first layers over few support
# rows, many support rows of narrow layers, and many rows at D=4096
WIDE_AND_DEEP = [((1, 5, 100, 2048, 2048, 64, 5), "shared"),
                 ((1, 10, 100, 2048, 2048, 64, 5), "shared"),
                 ((1, 5, 100, 2048, 4096, 64, 5), "device"),
                 ((1, 75, 100, 300, 64, 32, 5), "shared"),
                 ((1, 100, 100, 768, 64, 64, 5), "shared"),
                 ((1, 100, 100, 2048, 64, 32, 5), "shared"),
                 ((1, 125, 100, 2048, 64, 32, 5), "device"),
                 ((1, 64, 100, 4096, 256, 64, 5), "device")]


@pytest.mark.parametrize("dims, private", WIDE_AND_DEEP)
def test_plan_wide_layers_and_many_rows(dims, private):
    """The W1 tiles hold 256 hidden columns at most, so wide first layers
    plan; where a block's private buffers do not fit beside what the
    blocks exchange under any tile depth or query chunk, they go to device
    memory, and only the exchanged buffers and the tiles stay in shared
    memory."""
    B, S, Qn, D, H1, H2, N = dims
    plan = kernels.fused_adapt_plan(dims, H100_SMEM, H100_CLUSTER)
    assert plan.private == private
    assert plan.smem_bytes <= H100_SMEM
    shared, own = kernels._layout(S, D, H1, H2, N, plan.C, plan.tile_k,
                                  plan.query_rows)
    assert plan.smem_bytes == shared + (own if private == "shared" else 0)
    if private == "device":
        for q in {kernels.QUERY_ROWS, min(-(-S // 4) * 4, kernels.QUERY_ROWS)}:
            for t in kernels.TILE_K:
                assert sum(kernels._layout(S, D, H1, H2, N, plan.C, t,
                                           q)) > H100_SMEM


# ---------------------------------------------------------------------------
# fused_maml_adapt_batched: all tasks sharing one head in one launch
# ---------------------------------------------------------------------------

def batched_episodes(b, seed):
    rng = np.random.RandomState(seed)
    sx = rng.randn(b, N * K, D).astype(np.float32)
    qx = rng.randn(b, N * QN, D).astype(np.float32)
    sy = np.tile(np.repeat(np.arange(N), K), (b, 1)).astype(np.int32)
    return sx, sy, qx


@pytest.mark.parametrize("b", [1, 2, 3])
def test_batched_reference_matches_jax_batched_kernel(b):
    """The plain version against the JAX package's batched Pallas kernel
    in interpret mode, 10 steps, to the 2e-5 of tests/test_pallas.py; and
    equal to the port's per-task MAML form to 1e-6 (the JAX package holds
    its two kernels to that)."""
    params = jax_mlp.init(jax.random.PRNGKey(b), D, N, H)
    sx, sy, qx = batched_episodes(b, 10 + b)
    want = pk.fused_maml_adapt_batched(params, jnp.asarray(sx),
                                       jnp.asarray(sy), jnp.asarray(qx),
                                       STEPS, STEP, interpret=True)
    p = bridge.params_from_jax(np_tree(params), "maml", device="cpu")
    got = kernels.fused_maml_adapt_batched_reference(p, t(sx), t(sy), t(qx),
                                                     STEPS, STEP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    per_task = kernels.fused_maml_adapt(p, t(sx), t(sy), t(qx), STEPS, STEP)
    np.testing.assert_allclose(got.numpy(), per_task.numpy(), rtol=1e-6,
                               atol=1e-6)
    before = kernels.fused_maml_adapt_batched.launches
    wrapped = kernels.fused_maml_adapt_batched(p, t(sx), t(sy), t(qx), STEPS,
                                               STEP)
    assert torch.equal(wrapped, got)  # the CPU wrapper is the plain version
    assert kernels.fused_maml_adapt_batched.launches == before


def test_batched_rejects_wrong_depth():
    """As tests/test_pallas.py:133-140 holds the JAX kernels."""
    gen = torch.Generator().manual_seed(0)
    sx, sy, qx = (t(a) for a in batched_episodes(1, 0))
    shallow = mlp.init(gen, D, N, (8,))
    for fn in (kernels.fused_maml_adapt_batched,
               kernels.fused_maml_adapt_batched_reference):
        with pytest.raises(ValueError, match="2 hidden layers"):
            fn(shallow, sx, sy, qx, 1, STEP)


def test_batched_rejects_wrong_dtype_and_shape():
    gen = torch.Generator().manual_seed(0)
    p = mlp.init(gen, D, N, H)
    sx, sy, qx = (t(a) for a in batched_episodes(2, 1))
    with pytest.raises(TypeError):
        kernels.fused_maml_adapt_batched(p, sx.double(), sy, qx, 1, STEP)
    with pytest.raises(TypeError):
        kernels.fused_maml_adapt_batched(p, sx, sy.long(), qx, 1, STEP)
    with pytest.raises(ValueError):
        kernels.fused_maml_adapt_batched(p, sx, sy, qx[:, :, :-1], 1, STEP)
