"""The port's CUDA kernels and their plain PyTorch versions.

The counterparts of ``fumi_tpu/ops/pallas_kernels.py``:

- :func:`fused_adapt` (``fused_maml_adapt`` / ``fused_fumi_adapt``): the
  eval protocol runs 100 SGD adaptation steps per task, a long chain of
  small dependent products. One launch of ``csrc/fused_adapt.cu`` runs the
  whole adaptation of the 2-hidden-layer MLP plus its per-task head, and
  the query forward, each task on one thread-block cluster
  (:func:`fused_adapt_plan`), in the support set's Gram form: W1 is never
  formed, its change is carried as ``P``, the sum of the steps' dr1.
  Plain version: :func:`fused_adapt_reference`,
  the same hand-derived loop written with ``torch.matmul``.
- :func:`fused_maml_adapt_batched`: the same function for MAML's B tasks
  that share one head, through the same kernel with the head at a task
  stride of 0. Plain version: :func:`fused_maml_adapt_batched_reference`.
- :func:`gather_rows`: the row gather ``table[idx]`` of the TPU kernel,
  any dtype, byte for byte (``csrc/gather_rows.cu``). Plain version:
  :func:`gather_rows_reference`.
- :func:`augment_embeddings`: the ``--augment`` jitter ``x * (1 +
  U[-scale, scale))`` of the support embeddings, Philox4x32-10 bits keyed
  by a seed on the device and counted by position
  (``csrc/augment_embeddings.cu``). Plain version:
  :func:`augment_embeddings_reference`, the same bits in int64 arithmetic,
  bitwise equal.
- :func:`gather_augment_rows`: the same jitter as the epilogue of a
  row gather, widening the table's rows to fp32 on the way (a second entry
  point of ``csrc/gather_rows.cu``), one launch and the gather's bytes.
  Plain version: :func:`gather_augment_rows_reference`,
  ``augment_embeddings_reference(pixels_to_float(gather_rows_reference(
  ...)))``, bitwise equal.
- :func:`gather_episode_rows`: a whole episode in one launch (the third
  entry point of ``csrc/gather_rows.cu``): the support and query rows of
  the sampler's (B, N, K+Q) index tensor, widened, the support rows
  jittered where a seed is given. Plain version:
  :func:`gather_episode_rows_reference`, the same composition on each
  segment, bitwise equal. The sampler's kernel-gather route.
- :func:`norm_relu_pool`: conv4's batch-statistics norm, ReLU and 2×2
  max-pool of one block as one op (``csrc/norm_relu_pool.cu``), an
  autograd Function whose backward is a second Function, so that the
  forward, the backward and the double backward of second-order MAML are
  each a hand-written kernel; :func:`norm_leaky_relu` (resnet12's units c1
  and c2: the norm and leaky ReLU) and :func:`norm_residual_pool` (its
  unit c3 and the shortcut: two norms, their sum, leaky ReLU and the pool)
  are its other forms (:class:`NormForm`), the same kernels' other
  instances. They replace no TPU kernel: the JAX package leaves the chains
  to XLA. Plain versions: :func:`norm_relu_pool_forward_reference`,
  :func:`norm_relu_pool_backward_reference` and
  :func:`norm_relu_pool_double_backward_reference`, the same closed forms
  in PyTorch, given the form.
- :func:`conv3x3_fprop`, :func:`conv3x3_dgrad`, :func:`conv3x3_wgrad`:
  the stride-1 SAME 3x3 grouped convolution of conv4 and of resnet12's
  units, its input gradient and its weight gradient as fp32 implicit
  GEMMs on the CUDA cores
  (``csrc/conv3x3.cu``, tiled by :func:`conv3x3_plan`), three autograd
  Functions whose backwards are each other, so every order of
  differentiation stays on them. They replace no TPU kernel: the JAX
  package leaves the convolutions to XLA, the port sent them to cuDNN.
  Plain versions: :func:`conv3x3_fprop_reference`,
  :func:`conv3x3_dgrad_reference` and :func:`conv3x3_wgrad_reference`,
  the windows' products written out.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version. The design and bound of each kernel are in its
source's note. ``<wrapper>.launches`` counts kernel launches, so a run can
show that its main path went through the kernel. Each wrapper's call is
a :func:`~fumi_tpu_torch.utils.profiling.span` named after the wrapper, a
range on the trace while a ``torch.profiler`` runs (``--tpu_profile_dir``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from fumi_tpu_torch.models import mlp
from fumi_tpu_torch.models.fumi import im_net_depth
from fumi_tpu_torch.utils.profiling import spanned

# The fused kernel wins from this horizon on: on an NVIDIA H100 80GB HBM3
# (700 W) a FuMI request (R=1, 100 queries) took 1.17 ms through the kernel
# at 1 adaptation step against 3.33 ms through the autograd engine, and the
# kernel stayed ahead at 2, 4, 8 and 16 steps (PERF.md section 6).
MIN_FUSED_STEPS = 1


def _check(w1, b1, w2, b2, head_w, head_b, support_x, support_y, query_x,
           dtype=torch.float32):
    """Shapes, dtypes and devices the kernel takes; returns the dims."""
    floats = dict(w1=w1, b1=b1, w2=w2, b2=b2, head_w=head_w, head_b=head_b,
                  support_x=support_x, query_x=query_x)
    for name, t in floats.items():
        if t.dtype != dtype:
            raise TypeError(f"fused_adapt computes {dtype} only: {name} is "
                            f"{t.dtype}")
    if support_y.dtype != torch.int32:
        raise TypeError(f"support_y must be int32, got {support_y.dtype}")
    devices = {t.device for t in floats.values()} | {support_y.device}
    if len(devices) != 1:
        raise ValueError(f"fused_adapt inputs on several devices: {devices}")
    if support_x.dim() != 3 or query_x.dim() != 3:
        raise ValueError("support_x (B, S, D) and query_x (B, Qn, D)")
    B, S, D = support_x.shape
    Qn = query_x.shape[1]
    H1, H2 = w1.shape[0], w2.shape[0]
    N = head_w.shape[1] if head_w.dim() == 3 else -1
    want = {"w1": (H1, D), "b1": (H1,), "w2": (H2, H1), "b2": (H2,),
            "head_w": (B, N, H2), "support_y": (B, S),
            "query_x": (B, Qn, D)}
    got = {"w1": tuple(w1.shape), "b1": tuple(b1.shape),
           "w2": tuple(w2.shape), "b2": tuple(b2.shape),
           "head_w": tuple(head_w.shape),
           "support_y": tuple(support_y.shape),
           "query_x": tuple(query_x.shape)}
    for name in want:
        if got[name] != want[name]:
            raise ValueError(f"fused_adapt: {name} has shape {got[name]}, "
                             f"expected {want[name]}")
    if tuple(head_b.shape) not in ((B, 1, N), (B, N)):
        raise ValueError(f"fused_adapt: head_b has shape "
                         f"{tuple(head_b.shape)}, expected ({B}, 1, {N})")
    if min(B, S, Qn, D, H1, H2, N) < 1:
        raise ValueError("fused_adapt: every dimension must be >= 1")
    return B, S, Qn, D, H1, H2, N


def fused_adapt_reference(w1, b1, w2, b2, head_w, head_b,
                          support_x, support_y, query_x,
                          n_steps: int, step_size: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same per-task loop of
    forward, ``g = (softmax − onehot)/S``, hand-derived backprop and SGD on
    all six tensors, batched over the B tasks. Returns (B, Qn, N).

    fp32 like the kernel; given fp64 tensors throughout, it evaluates the
    same loop in fp64, the yardstick for how far fp32 rounding carries
    over the steps."""
    dtype = (torch.float64 if support_x.dtype == torch.float64
             else torch.float32)
    B, S, Qn, D, H1, H2, N = _check(w1, b1, w2, b2, head_w, head_b,
                                    support_x, support_y, query_x, dtype)
    x = support_x
    classes = torch.arange(N, device=support_y.device)
    y1h = (support_y.unsqueeze(-1) == classes).to(dtype)
    # private per-task copies of the shared init and of the heads
    W1 = w1.expand(B, H1, D).clone()
    c1 = b1.expand(B, H1).clone()
    W2 = w2.expand(B, H2, H1).clone()
    c2 = b2.expand(B, H2).clone()
    W3 = head_w.clone()
    c3 = head_b.reshape(B, N).clone()

    def forward(inp):
        a1 = torch.matmul(inp, W1.mT) + c1.unsqueeze(1)
        r1 = torch.relu(a1)
        a2 = torch.matmul(r1, W2.mT) + c2.unsqueeze(1)
        r2 = torch.relu(a2)
        return a1, r1, a2, r2, torch.matmul(r2, W3.mT) + c3.unsqueeze(1)

    for _ in range(n_steps):
        a1, r1, a2, r2, logits = forward(x)
        z = logits - logits.amax(dim=-1, keepdim=True)
        e = torch.exp(z)
        p = e / e.sum(dim=-1, keepdim=True)
        g = (p - y1h) / float(S)  # (B, S, N)

        dW3 = torch.matmul(g.mT, r2)
        db3 = g.sum(dim=1)
        dr2 = torch.where(a2 > 0, torch.matmul(g, W3), 0.0)
        dW2 = torch.matmul(dr2.mT, r1)
        db2 = dr2.sum(dim=1)
        dr1 = torch.where(a1 > 0, torch.matmul(dr2, W2), 0.0)
        dW1 = torch.matmul(dr1.mT, x)
        db1 = dr1.sum(dim=1)

        W1 = W1 - step_size * dW1
        W2 = W2 - step_size * dW2
        W3 = W3 - step_size * dW3
        c1 = c1 - step_size * db1
        c2 = c2 - step_size * db2
        c3 = c3 - step_size * db3
    return forward(query_x)[-1]


# The launch plan of csrc/fused_adapt.cu. The tile constants and _layout
# follow the source's kRows, kCols, kQueryRows, kGroupCols, kMaxCluster and
# make_dims(); its launch function recomputes the layout and refuses a plan
# that does not match it.
_ROWS, _COLS, QUERY_ROWS, _GROUP_COLS = 4, 8, 32, 256
MAX_CLUSTER = 16
# rows of the W1 tiles the D-deep passes stage, the deepest that fits first
TILE_K = (32, 16, 8)
# below this many D columns a block, its SM would mostly wait at the
# cluster barriers: the plan takes a smaller cluster instead
MIN_BLOCK_COLS = 32


class FusedAdaptPlan(NamedTuple):
    """How the kernel spreads a task: ``C`` blocks (one cluster) of
    ``cols`` columns of D each, W1 staged ``tile_k`` rows of the slice at a
    time, the queries ``query_rows`` at a time, a block's private buffers
    in ``"shared"`` or ``"device"`` memory, ``smem_bytes`` of shared
    memory a block."""
    C: int
    cols: int
    tile_k: int
    query_rows: int
    private: str
    smem_bytes: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _layout(S, D, H1, H2, N, C, tile_k, query_rows) -> Tuple[int, int]:
    """A block's bytes of the source's shared segments (what the cluster's
    blocks exchange, and the W1 tiles) and of its private ones, each
    segment padded to 16 bytes."""
    SP, DP = _round_up(S, _ROWS), _round_up(-(-D // C), tile_k)
    AP, LG = max(SP, query_rows), min(_round_up(H1, _COLS), _GROUP_COLS) + 4
    H2P, RG = _round_up(H2, 4), -(-AP // C)
    HC, JC = _round_up(-(-H1 // C), 4), _round_up(-(-H2 // C), 4)
    shared = (2 * tile_k * LG, max(C * AP * max(HC, JC), 2 * RG * SP),
              AP * (H2P + 4), 4)
    private = (DP * SP, DP * query_rows, AP * HC, AP * HC, SP * HC, SP * H2P,
               SP * N, SP * N, HC * (H2P + 4), HC, H2P, N * (H2P + 4), N, SP,
               2 * AP * SP, 2 * SP * HC)
    return tuple(4 * sum(_round_up(n, 4) for n in sizes)
                 for sizes in (shared, private))


def fused_adapt_plan(dims: Tuple[int, ...], smem_optin: int,
                     max_cluster: int) -> FusedAdaptPlan:
    """The plan for ``dims = (B, S, Qn, D, H1, H2, N)`` on a card whose
    blocks may opt in to ``smem_optin`` bytes of shared memory and which
    schedules clusters of up to ``max_cluster`` blocks of the kernel.

    C is the largest cluster the card schedules (16 at most) that leaves
    each block ``MIN_BLOCK_COLS`` columns of D; a block owns ``cols =
    ceil(D / C)`` of them (the last one fewer where C does not divide D).
    The queries go ``QUERY_ROWS`` at a time, or as many as the support
    rows where fewer fit, and the W1 tiles are the deepest of ``TILE_K``
    that fits. A block's private buffers stay in shared memory where some
    such choice lets them, else they go to device memory. Raises where not
    even the exchanged buffers and the tiles fit."""
    B, S, Qn, D, H1, H2, N = dims
    C = max(1, min(MAX_CLUSTER, max_cluster, D // MIN_BLOCK_COLS))
    SP = _round_up(S, _ROWS)
    options = [(q, t) for q in dict.fromkeys((QUERY_ROWS, min(SP, QUERY_ROWS)))
               for t in TILE_K]
    for private in ("shared", "device"):
        for query_rows, tile_k in options:
            shared, own = _layout(S, D, H1, H2, N, C, tile_k, query_rows)
            nbytes = shared + (own if private == "shared" else 0)
            if nbytes <= smem_optin:
                return FusedAdaptPlan(C, -(-D // C), tile_k, query_rows,
                                      private, nbytes)
    raise RuntimeError(
        f"fused_adapt: no launch fits the card (B={B} S={S} Qn={Qn} D={D} "
        f"H1={H1} H2={H2} N={N}): what the blocks exchange needs {nbytes} "
        f"bytes of shared memory a block at {C} blocks per task, the card "
        f"gives a block {smem_optin}")


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signatures declared."""
    from fumi_tpu_torch.ops import _build
    lib = _build.load("fused_adapt")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_adapt_launch.argtypes = (
        [ptr] * 11 + [i64] * 2 + [i32] * 12
        + [i64, i64, i32, ctypes.c_float, ptr])
    lib.fused_adapt_launch.restype = i32
    lib.fused_adapt_smem_bytes.argtypes = [i32] * 9
    lib.fused_adapt_smem_bytes.restype = i64
    lib.fused_adapt_card_limits.argtypes = [ptr, ptr]
    lib.fused_adapt_card_limits.restype = i32
    lib.fused_adapt_active_clusters.argtypes = [i32, i32, ptr]
    lib.fused_adapt_active_clusters.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def card_limits(device_index: int) -> Tuple[int, int]:
    """``(smem_optin, max_cluster)`` of a card for the kernel: the shared
    memory a block may opt in to, and the largest cluster of the kernel
    the card schedules at that much shared memory a block."""
    optin, cluster = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        err = _library().fused_adapt_card_limits(ctypes.byref(optin),
                                                 ctypes.byref(cluster))
    if err != 0:
        raise RuntimeError(f"fused_adapt: reading the card's limits failed "
                           f"with CUDA error {err}")
    return optin.value, cluster.value


@functools.lru_cache(maxsize=None)
def active_clusters(device_index: int, C: int, smem_bytes: int) -> int:
    """How many clusters of C blocks with ``smem_bytes`` each the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int()
    with torch.cuda.device(device_index):
        err = _library().fused_adapt_active_clusters(C, smem_bytes,
                                                     ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"fused_adapt: cluster occupancy query failed "
                           f"with CUDA error {err} (C={C}, {smem_bytes} B)")
    return n.value


def device_plan(device_index: int, dims: Tuple[int, ...]) -> FusedAdaptPlan:
    """:func:`fused_adapt_plan` for a card; raises where the card cannot
    schedule even one such cluster."""
    plan = fused_adapt_plan(dims, *card_limits(device_index))
    if active_clusters(device_index, plan.C, plan.smem_bytes) < 1:
        raise RuntimeError(f"fused_adapt: the card schedules no cluster of "
                           f"{plan} (dims {dims})")
    return plan


def _launch(who, w1, b1, w2, b2, head_w, head_b, head_strides, support_x,
            support_y, query_x, dims, n_steps, step_size):
    """One launch of ``csrc/fused_adapt.cu``; head_w / head_b hold the
    tasks' heads at ``head_strides`` floats apart (0: one shared head)."""
    tensors = (support_x, support_y, query_x, w1, b1, w2, b2, head_w, head_b)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{who} takes contiguous tensors")
    B, S, Qn, D, H1, H2, N = dims
    dev = support_x.device
    plan = device_plan(dev.index, dims)
    out = torch.empty((B, Qn, N), dtype=torch.float32, device=dev)
    # the blocks' private buffers, where they are not in shared memory
    floats, scratch = 0, None
    if plan.private == "device":
        floats = B * plan.C * _layout(S, D, H1, H2, N, plan.C, plan.tile_k,
                                      plan.query_rows)[1] // 4
        scratch = torch.empty((floats,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in tensors + (out,)]
    ptrs.append(None if scratch is None else scratch.data_ptr())
    err = _library().fused_adapt_launch(
        *ptrs, *head_strides, B, S, Qn, D, H1, H2, N, plan.C, plan.cols,
        plan.tile_k, plan.query_rows, int(plan.private == "device"),
        plan.smem_bytes, floats, int(n_steps), float(step_size), stream)
    if err != 0:
        raise RuntimeError(
            f"{who} kernel launch failed with CUDA error {err} (B={B} S={S} "
            f"Qn={Qn} D={D} H1={H1} H2={H2} N={N}; {plan})")
    return out


@spanned
def fused_adapt(w1, b1, w2, b2, head_w, head_b,
                support_x: torch.Tensor, support_y: torch.Tensor,
                query_x: torch.Tensor, n_steps: int,
                step_size: float) -> torch.Tensor:
    """Query logits after n_steps of per-task SGD adaptation of a
    2-hidden-layer MLP + per-task head.

    w1 (H1, D), w2 (H2, H1) and the biases are the SHARED init; head_w
    (B, N, H2) / head_b (B, 1, N) are PER TASK (FuMI's hypernet-generated
    head, or MAML's shared head broadcast over tasks). support_x (B, S, D)
    fp32, support_y (B, S) int32, query_x (B, Qn, D) fp32. Returns
    (B, Qn, N) fp32. CUDA tensors launch the kernel, one cluster of
    thread blocks per task (:func:`fused_adapt_plan`); CPU tensors run
    :func:`fused_adapt_reference`."""
    tensors = (w1, b1, w2, b2, head_w, head_b, support_x, support_y, query_x)
    dims = _check(*tensors)
    dev = support_x.device
    if dev.type == "cpu":
        return fused_adapt_reference(*tensors, n_steps, step_size)
    if dev.type != "cuda":
        raise ValueError(f"fused_adapt runs on cuda or cpu, not {dev}")
    H2, N = dims[5:]
    out = _launch("fused_adapt", *tensors[:6], (N * H2, N), *tensors[6:],
                  dims, n_steps, step_size)
    fused_adapt.launches += 1
    return out


fused_adapt.launches = 0


def fused_adapt_supported(im_hid_dim: Sequence[int], n_steps: int,
                          device: torch.device) -> bool:
    """Whether the kernel covers this geometry: the 2-hidden-layer stack on
    a CUDA device, with a horizon long enough that the kernel's fixed cost
    wins (``MIN_FUSED_STEPS``)."""
    return (len(tuple(im_hid_dim)) == 2 and n_steps >= MIN_FUSED_STEPS
            and torch.device(device).type == "cuda")


def fused_adapt_applicable(model: str, im_encoder: str,
                           im_hid_dim: Sequence[int], n_steps: int,
                           device: torch.device) -> bool:
    """Which configs the fused kernel covers: the MAML/FuMI embedding
    stacks (raw-image backbones and other geometries use the autograd
    engine)."""
    return (model in ("maml", "fumi")
            and im_encoder not in ("conv4", "resnet12")
            and fused_adapt_supported(im_hid_dim, n_steps, device))


def _maml_tensors(params: Dict[str, torch.Tensor], B: int):
    """MAML's state dict as (w1, b1, w2, b2, head_w, head_b) with the
    shared head broadcast over B tasks (expanded views)."""
    if len(mlp.layer_names(params)) != 3:
        raise ValueError("fused kernel supports exactly 2 hidden layers")
    w3, b3 = params["net.lin_final.weight"], params["net.lin_final.bias"]
    N = w3.shape[0]
    return (params["net.lin_0.weight"], params["net.lin_0.bias"],
            params["net.lin_1.weight"], params["net.lin_1.bias"],
            w3.expand((B,) + tuple(w3.shape)),
            b3.reshape(1, 1, N).expand(B, 1, N))


def fused_maml_adapt(params: Dict[str, torch.Tensor], support_x, support_y,
                     query_x, n_steps: int, step_size: float) -> torch.Tensor:
    """MAML form of :func:`fused_adapt`: ``params`` is the MLP state dict
    (2 hidden layers); its head broadcasts across tasks."""
    w = _maml_tensors(params, support_x.shape[0])
    return fused_adapt(*w[:4], w[4].contiguous(), w[5].contiguous(),
                       support_x, support_y, query_x, n_steps, step_size)


# ---------------------------------------------------------------------------
# Fused adaptation of tasks that share one head, spread over the card
# ---------------------------------------------------------------------------

def fused_maml_adapt_batched_reference(params: Dict[str, torch.Tensor],
                                       support_x, support_y, query_x,
                                       n_steps: int, step_size: float
                                       ) -> torch.Tensor:
    """Plain version: :func:`fused_adapt_reference` with MAML's head
    broadcast over the tasks."""
    return fused_adapt_reference(*_maml_tensors(params, support_x.shape[0]),
                                 support_x, support_y, query_x, n_steps,
                                 step_size)


@spanned
def fused_maml_adapt_batched(params: Dict[str, torch.Tensor],
                             support_x: torch.Tensor, support_y: torch.Tensor,
                             query_x: torch.Tensor, n_steps: int,
                             step_size: float) -> torch.Tensor:
    """:func:`fused_maml_adapt` for MAML's B tasks in one launch of the
    same kernel, ``csrc/fused_adapt.cu``, with the shared head read in
    place (a task stride of 0) rather than copied per task. ``params`` is
    MAML's state dict (2 hidden layers); support_x (B, S, D) fp32,
    support_y (B, S) int32, query_x (B, Qn, D) fp32. Returns (B, Qn, N)
    fp32. CPU tensors run :func:`fused_maml_adapt_batched_reference`."""
    w = _maml_tensors(params, support_x.shape[0])
    dims = _check(*w, support_x, support_y, query_x)
    dev = support_x.device
    if dev.type == "cpu":
        return fused_maml_adapt_batched_reference(params, support_x,
                                                  support_y, query_x,
                                                  n_steps, step_size)
    if dev.type != "cuda":
        raise ValueError(f"fused_maml_adapt_batched runs on cuda or cpu, "
                         f"not {dev}")
    out = _launch("fused_maml_adapt_batched", *w[:4],
                  params["net.lin_final.weight"],
                  params["net.lin_final.bias"], (0, 0), support_x,
                  support_y, query_x, dims, n_steps, step_size)
    fused_maml_adapt_batched.launches += 1
    return out


fused_maml_adapt_batched.launches = 0


def fused_fumi_adapt(im_params: Dict[str, torch.Tensor],
                     hyper0: torch.Tensor, support_x, support_y, query_x,
                     n_steps: int, step_size: float) -> torch.Tensor:
    """FuMI form of :func:`fused_adapt`: the per-task generated head comes
    from the hypernetwork output ``hyper0`` (B, N, H2+1), weights in
    ``[:, :, :-1]`` and bias in ``[:, :, -1]``. FuMI's eval inner loop
    SGD-updates (im_net, head) jointly at one step size, which is exactly
    the kernel's update."""
    if im_net_depth(im_params) != 2:
        raise ValueError("fused kernel supports exactly 2 hidden layers")
    B, N = hyper0.shape[0], hyper0.shape[1]
    head_w = hyper0[:, :, :-1].contiguous()
    head_b = hyper0[:, :, -1].reshape(B, 1, N).contiguous()
    return fused_adapt(im_params["im_net.linear0.weight"],
                       im_params["im_net.linear0.bias"],
                       im_params["im_net.linear1.weight"],
                       im_params["im_net.linear1.bias"],
                       head_w, head_b, support_x, support_y, query_x,
                       n_steps, step_size)


# ---------------------------------------------------------------------------
# Row gather
# ---------------------------------------------------------------------------

def gather_rows_reference(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table[idx]`` as one ``index_select``."""
    return torch.index_select(table, 0, idx.long())


@functools.lru_cache(maxsize=None)
def _gather_library():
    """``csrc/gather_rows.cu``: one kernel body behind three entry points
    (the byte copy, the jittered rows, the episode)."""
    from fumi_tpu_torch.ops import _build
    return bind_gather(_build.load("gather_rows"))


def bind_gather(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/gather_rows.cu`` (or a copy of it)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gather_rows_launch.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.gather_augment_launch.argtypes = [ptr, i32, ptr, ptr, ptr, i64, i64,
                                          i32, i64, ctypes.c_float, ptr]
    lib.gather_episode_launch.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, i64,
                                          i64, i32, i32, i32, ctypes.c_float,
                                          ptr]
    for fn in (lib.gather_rows_launch, lib.gather_augment_launch,
               lib.gather_episode_launch):
        fn.restype = i32
    return lib


def _check_gather(who: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{who} takes a contiguous 2-D table, got "
                         f"shape {tuple(table.shape)}"
                         f"{'' if table.is_contiguous() else ', strided'}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"{who} takes 1-D int32 indices, got "
                        f"{idx.dtype} of shape {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError(f"{who}: table on {table.device}, indices "
                         f"on {idx.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who} runs on cuda or cpu, not {table.device}")


@spanned
def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``(R, D)[(M,)] -> (M, D)``, bitwise ``table[idx]``.

    ``table`` is 2-D and contiguous, of any dtype (the kernel copies row
    bytes); ``idx`` is 1-D int32 on the same device. A CUDA table launches
    ``csrc/gather_rows.cu``'s ``gather_rows_launch`` (an index outside
    ``[0, R)`` raises at the next synchronisation); a CPU table runs
    :func:`gather_rows_reference`."""
    _check_gather("gather_rows", table, idx)
    dev = table.device
    if dev.type == "cpu":
        return gather_rows_reference(table, idx)
    idx = idx.contiguous()
    M, (R, D) = idx.shape[0], table.shape
    out = torch.empty((M, D), dtype=table.dtype, device=dev)
    if M == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _gather_library().gather_rows_launch(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, M,
        D * table.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed with CUDA "
                           f"error {err} (R={R} D={D} M={M} {table.dtype})")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


# ---------------------------------------------------------------------------
# Embedding jitter (--augment)
# ---------------------------------------------------------------------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # Weyl key increments
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product of the constant ``a``
    and the uint32 values in the int64 tensor ``b``, in int64 arithmetic
    that never overflows (16-bit halves of ``b``)."""
    p0 = a * (b & 0xFFFF)  # < 2**48
    mid = (p0 >> 16) + a * (b >> 16)  # < 2**49
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p0 & 0xFFFF)


def philox4x32_10(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of int64 tensors holding uint32 words: ``counter``
    (..., 4) and ``key`` (2,) -> (..., 4), the kernel's generator."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key[0], key[1]
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _check_seed(who: str, seed: torch.Tensor, what: str,
                device: torch.device, row_offset: int = 0) -> None:
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise TypeError(f"{who} takes a one-element int64 seed "
                        f"tensor, got {seed.dtype} of shape "
                        f"{tuple(seed.shape)}")
    if seed.device != device:
        raise ValueError(f"{who}: {what} on {device}, seed on {seed.device}")
    if row_offset < 0:
        raise ValueError(f"{who}: row_offset {row_offset} < 0")


def _check_augment(x: torch.Tensor, seed: torch.Tensor,
                   row_offset: int = 0) -> None:
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"augment_embeddings takes 2-D float32 x, got "
                        f"{x.dtype} of shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"augment_embeddings takes a contiguous x, got "
                         f"strides {x.stride()} for shape {tuple(x.shape)}")
    _check_seed("augment_embeddings", seed, "x", x.device, row_offset)


def augment_embeddings_reference(x: torch.Tensor, seed: torch.Tensor,
                                 scale: float = 0.1,
                                 row_offset: int = 0) -> torch.Tensor:
    """Plain version of the kernel, bitwise. Element (r, j) takes word
    ``j % 4`` of Philox4x32-10 at counter ``(j // 4, R mod 2**32, R >> 32,
    0)``, ``R = row_offset + r``, keyed by the 64-bit seed; its low 23 bits
    make u in [1, 2), and ``out = x * (1 + (u - 1.5) * 2·scale)``, rounded
    step by step in fp32. Runs on the tensors' device without reading the
    seed on the host."""
    _check_augment(x, seed, row_offset)
    M, D = x.shape
    G = (D + 3) // 4
    dev = x.device
    rows = torch.arange(M, dtype=torch.int64, device=dev) + int(row_offset)
    cols = torch.arange(G, dtype=torch.int64, device=dev)
    rr, cc = rows[:, None].expand(M, G), cols[None, :].expand(M, G)
    counter = torch.stack([cc, rr & _U32, rr >> 32, torch.zeros_like(rr)],
                          dim=-1)
    s = seed.reshape(1)
    key = torch.cat([s & _U32, (s >> 32) & _U32])
    bits = philox4x32_10(counter, key).reshape(M, 4 * G)[:, :D]
    u = ((bits & 0x7FFFFF) | 0x3F800000).to(torch.int32).view(torch.float32)
    # a Python scalar enters a float32 op rounded to float32, as the
    # kernel's float argument is
    factor = 1.0 + (u - 1.5) * (2.0 * scale)
    return x * factor


@functools.lru_cache(maxsize=None)
def _augment_library():
    from fumi_tpu_torch.ops import _build
    lib = _build.load("augment_embeddings")
    ptr = ctypes.c_void_p
    i64 = ctypes.c_longlong
    lib.augment_embeddings_launch.argtypes = [ptr, ptr, ptr, i64, ctypes.c_int,
                                              i64, ctypes.c_float, ptr]
    lib.augment_embeddings_launch.restype = ctypes.c_int
    return lib


@spanned
def augment_embeddings(x: torch.Tensor, seed: torch.Tensor,
                       scale: float = 0.1, row_offset: int = 0
                       ) -> torch.Tensor:
    """Multiplicative uniform jitter ``x * (1 + U[-scale, scale))`` of a
    contiguous (M, D) fp32 tensor, any M and D, from a one-element int64
    ``seed`` tensor on x's device. The result depends on the seed and each
    element's position only: x's row r counts as row ``row_offset + r``,
    so a row slice of a larger tensor, given its offset, jitters as the
    whole does. A CUDA x launches ``csrc/augment_embeddings.cu``; a CPU x
    runs :func:`augment_embeddings_reference`."""
    _check_augment(x, seed, row_offset)
    dev = x.device
    if dev.type == "cpu":
        return augment_embeddings_reference(x, seed, scale, row_offset)
    if dev.type != "cuda":
        raise ValueError(f"augment_embeddings runs on cuda or cpu, not {dev}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _augment_library().augment_embeddings_launch(
        x.data_ptr(), seed.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], int(row_offset), 2.0 * scale, stream)
    if err != 0:
        raise RuntimeError(f"augment_embeddings kernel launch failed with "
                           f"CUDA error {err} (shape {tuple(x.shape)})")
    augment_embeddings.launches += 1
    return out


augment_embeddings.launches = 0


# ---------------------------------------------------------------------------
# Row gathers that widen, with the jitter as their epilogue
# ---------------------------------------------------------------------------

def pixels_to_float(im: torch.Tensor) -> torch.Tensor:
    """Gather-time dtype policy for episode image leaves: integer tables
    are raw pixels -> fp32 in [0, 1]; other floats (bf16 tables) -> fp32;
    fp32 passes through."""
    if not im.dtype.is_floating_point:
        return im.to(torch.float32) * (1.0 / 255.0)
    if im.dtype != torch.float32:
        return im.to(torch.float32)
    return im


# the table dtypes the kernel widens, by csrc/gather_rows.cu's TableKind
_TABLE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def _check_gather_augment(table, idx, seed, row_offset) -> None:
    who = "gather_augment_rows"
    _check_gather(who, table, idx)
    if table.dtype not in _TABLE_KINDS:
        raise TypeError(f"{who} takes float32, bfloat16 or uint8 tables, "
                        f"got {table.dtype}")
    _check_seed(who, seed, "table", table.device, row_offset)


def gather_augment_rows_reference(table: torch.Tensor, idx: torch.Tensor,
                                  seed: torch.Tensor, scale: float = 0.1,
                                  row_offset: int = 0) -> torch.Tensor:
    """Plain version of the kernel, bitwise: the gather, the sampler's
    widening and the jitter one after the other."""
    _check_gather_augment(table, idx, seed, row_offset)
    return augment_embeddings_reference(
        pixels_to_float(gather_rows_reference(table, idx)), seed, scale,
        row_offset)


@spanned
def gather_augment_rows(table: torch.Tensor, idx: torch.Tensor,
                        seed: torch.Tensor, scale: float = 0.1,
                        row_offset: int = 0) -> torch.Tensor:
    """``augment_embeddings(pixels_to_float(gather_rows(table, idx)), seed,
    scale, row_offset)`` in one pass: (M, D) fp32 from a contiguous (R, D)
    float32, bfloat16 or uint8 table, 1-D int32 ``idx`` and a one-element
    int64 ``seed``, all on one device. Output row m is jittered as row
    ``row_offset + m``. A CUDA table launches ``csrc/gather_rows.cu``'s
    ``gather_augment_launch`` (an index outside ``[0, R)`` raises at the
    next synchronisation); a CPU table runs
    :func:`gather_augment_rows_reference`."""
    _check_gather_augment(table, idx, seed, row_offset)
    dev = table.device
    if dev.type == "cpu":
        return gather_augment_rows_reference(table, idx, seed, scale,
                                             row_offset)
    idx = idx.contiguous()
    M, (R, D) = idx.shape[0], table.shape
    out = torch.empty((M, D), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _gather_library().gather_augment_launch(
        table.data_ptr(), _TABLE_KINDS[table.dtype], idx.data_ptr(),
        seed.data_ptr(), out.data_ptr(), R, M, D, int(row_offset),
        2.0 * scale, stream)
    if err != 0:
        raise RuntimeError(f"gather_augment_rows kernel launch failed with "
                           f"CUDA error {err} (R={R} D={D} M={M} "
                           f"{table.dtype})")
    gather_augment_rows.launches += 1
    return out


gather_augment_rows.launches = 0


def _check_episode(table, rows, num_shots, seed, scale) -> None:
    who = "gather_episode_rows"
    if rows.dtype != torch.int32 or rows.dim() != 3:
        raise TypeError(f"{who} takes (B, N, K+Q) int32 rows, got "
                        f"{rows.dtype} of shape {tuple(rows.shape)}")
    _check_gather(who, table, rows.reshape(-1))
    if table.dtype not in _TABLE_KINDS:
        raise TypeError(f"{who} takes float32, bfloat16 or uint8 tables, "
                        f"got {table.dtype}")
    if not 0 <= num_shots <= rows.shape[2]:
        raise ValueError(f"{who}: num_shots {num_shots} outside [0, "
                         f"{rows.shape[2]}] (rows of shape "
                         f"{tuple(rows.shape)})")
    if seed is not None:
        _check_seed(who, seed, "table", table.device)
    elif scale != 0.0:
        raise ValueError(f"{who}: scale {scale} without a seed")


def gather_episode_rows_reference(table: torch.Tensor, rows: torch.Tensor,
                                  num_shots: int,
                                  seed: Optional[torch.Tensor] = None,
                                  scale: float = 0.0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, bitwise: the support and query rows
    apart, each gathered and widened, and the support rows jittered."""
    _check_episode(table, rows, num_shots, seed, scale)
    B, N, P = rows.shape
    K, D = num_shots, table.shape[1]
    support = pixels_to_float(gather_rows_reference(
        table, rows[..., :K].reshape(-1)))
    if seed is not None:
        support = augment_embeddings_reference(support, seed, scale)
    query = pixels_to_float(gather_rows_reference(
        table, rows[..., K:].reshape(-1)))
    return (support.reshape(B, N * K, D),
            query.reshape(B, N * (P - K), D))


@spanned
def gather_episode_rows(table: torch.Tensor, rows: torch.Tensor,
                        num_shots: int, seed: Optional[torch.Tensor] = None,
                        scale: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An episode's image rows in one pass: ``(support (B, N·K, D), query
    (B, N·Q, D))`` fp32 from a contiguous (R, D) float32, bfloat16 or uint8
    table and the sampler's (B, N, K+Q) int32 ``rows``, K = ``num_shots``.
    Of class n's K+Q indices the first K make support rows n·K + j, the
    rest query rows n·Q + j − K; both are widened as
    :func:`pixels_to_float` does. With a one-element int64 ``seed`` the
    support rows are jittered at ``scale``, support row m of the flattened
    (B·N·K, D) block as ``gather_augment_rows`` jitters row m; the queries
    never are. A CUDA table launches ``csrc/gather_rows.cu``'s
    ``gather_episode_launch`` (an index outside ``[0, R)`` raises at the
    next synchronisation); a CPU table runs
    :func:`gather_episode_rows_reference`."""
    _check_episode(table, rows, num_shots, seed, scale)
    dev = table.device
    if dev.type == "cpu":
        return gather_episode_rows_reference(table, rows, num_shots, seed,
                                             scale)
    rows = rows.contiguous()
    B, N, P = rows.shape
    (R, D), K = table.shape, num_shots
    support = torch.empty((B, N * K, D), dtype=torch.float32, device=dev)
    query = torch.empty((B, N * (P - K), D), dtype=torch.float32, device=dev)
    if rows.numel() == 0 or D == 0:
        return support, query
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return t.data_ptr() if t.numel() else None
    err = _gather_library().gather_episode_launch(
        table.data_ptr(), _TABLE_KINDS[table.dtype], rows.data_ptr(),
        None if seed is None else seed.data_ptr(), ptr(support), ptr(query),
        R, B * N, K, P - K, D, 2.0 * scale, stream)
    if err != 0:
        raise RuntimeError(f"gather_episode_rows kernel launch failed with "
                           f"CUDA error {err} (R={R} D={D} rows "
                           f"{tuple(rows.shape)} K={K} {table.dtype})")
    gather_episode_rows.launches += 1
    return support, query


gather_episode_rows.launches = 0


# ---------------------------------------------------------------------------
# the batch-statistics norm, ReLU or leaky ReLU and 2x2 max-pool of conv4's
# blocks and resnet12's units (csrc/norm_relu_pool.cu)
# ---------------------------------------------------------------------------

# conv4's norm epsilon (models/conv4.py EPS)
NORM_EPS = 1e-5
# resnet12's leaky ReLU slope (models/resnet12.py LEAK is this; the
# kernels' kLeak)
NORM_LEAK = 0.1
# the launch plan of csrc/norm_relu_pool.cu: a block covers at most
# _NRP_MAX_VECS vectors of channels (its kMaxVecs); the sums' walks take up
# to _NRP_BLOCKS_PER_SM blocks an SM, one partial row each
_NRP_MAX_VECS, _NRP_BLOCKS_PER_SM = 64, 4


class NormForm(NamedTuple):
    """One of ``csrc/norm_relu_pool.cu``'s three instances: leaky ReLU
    (slope :data:`NORM_LEAK`) or ReLU, the 2×2 max-pool after it or none,
    and how many normed branches are summed before the activation."""
    leaky: bool
    pool: bool
    branches: int


RELU_POOL = NormForm(False, True, 1)       # conv4's block
LEAKY = NormForm(True, False, 1)           # resnet12's units c1 and c2
LEAKY_SUM_POOL = NormForm(True, True, 2)   # resnet12's c3 and shortcut


class NormReluPoolPlan(NamedTuple):
    """How ``csrc/norm_relu_pool.cu`` walks a (M, G, H, W) tensor: ``vec``
    channels a thread (4 where G allows it and every activation is 16-byte
    aligned, else 1), ``tx`` channel vectors a block, and at most ``rows``
    blocks along the cells, each writing one row of partial sums."""
    vec: int
    tx: int
    rows: int


def norm_relu_pool_plan(G: int, aligned: bool, sms: int) -> NormReluPoolPlan:
    """The plan for G channels on a card of ``sms`` SMs: about
    ``_NRP_BLOCKS_PER_SM`` blocks an SM in all, over the channel blocks
    (``ceil(G / vec / tx)``) and the cells."""
    vec = 4 if G % 4 == 0 and aligned else 1
    tx = min(G // vec, _NRP_MAX_VECS)
    channel_blocks = -(-(G // vec) // tx)
    return NormReluPoolPlan(vec, tx,
                            max(1, _NRP_BLOCKS_PER_SM * sms // channel_blocks))


def _nrp_chan(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(1, -1, 1, 1)


def _nrp_windows(t: torch.Tensor) -> torch.Tensor:
    """(M, G, H, W) -> its pooled region as (M, G, H/2, 2, W/2, 2)."""
    M, G, H, W = t.shape
    h2, w2 = H // 2, W // 2
    return t[:, :, :2 * h2, :2 * w2].reshape(M, G, h2, 2, w2, 2)


def _nrp_branches(tensors) -> list:
    """The flat (z, bias, gamma, beta) of each branch, as tuples."""
    return [tuple(tensors[i:i + 4]) for i in range(0, len(tensors), 4)]


def _nrp_normed(z, bias, gamma, beta, stats):
    """x = (z + b − μ)·rstd and a = γx + β, stats = (μ, rstd)."""
    x = (z + _nrp_chan(bias) - _nrp_chan(stats[0])) * _nrp_chan(stats[1])
    return x, x * _nrp_chan(gamma) + _nrp_chan(beta)


def _nrp_summed(tensors, stats):
    """Each branch's x, and a = Σ γ_k·x_k + β_k over the branches; branch
    k's (μ, rstd) are rows 2k and 2k + 1 of ``stats``."""
    xs, a = [], None
    for k, (z, b, g, be) in enumerate(_nrp_branches(tensors)):
        x, ak = _nrp_normed(z, b, g, be, stats[2 * k:2 * k + 2])
        xs.append(x)
        a = ak if a is None else a + ak
    return xs, a


def _nrp_act(form: NormForm, a: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(a, NORM_LEAK) if form.leaky else a.clamp_min(0.0)


def _nrp_sloped(form: NormForm, a: torch.Tensor, g: torch.Tensor):
    """g·act'(a), with act'(a) = 0.1 (leaky) or 0 (ReLU) for a <= 0, as
    torch's backwards take them."""
    return torch.where(a > 0, g, g * NORM_LEAK if form.leaky else 0.0)


def _nrp_route(form: NormForm, a: torch.Tensor, g_out: torch.Tensor):
    """``(ga, routed, ties)``: ga (M, G, H, W) is g_out times act'(a), with
    the pool split evenly over each window's ties of max(act(a)) (under
    ReLU kept where a > 0) and zero outside the pooled region; ``routed``
    (the windows' mask of where it went) and ``ties`` (M, G, H/2, 1, W/2,
    1), as amax counts them; None for both without the pool."""
    if not form.pool:
        return _nrp_sloped(form, a, g_out), None, None
    M, G, H, W = a.shape
    win = _nrp_windows(a)
    h = _nrp_act(form, win)
    tie = h == h.amax(dim=(3, 5), keepdim=True)
    ties = tie.sum(dim=(3, 5), keepdim=True).to(a.dtype)
    routed = tie if form.leaky else tie & (win > 0)
    share = g_out.reshape(win.shape[:3] + (1, win.shape[4], 1)) / ties
    if form.leaky:
        share = _nrp_sloped(form, win, share)
    ga = torch.where(routed, share, 0.0).reshape(
        M, G, 2 * win.shape[2], 2 * win.shape[4])
    return F.pad(ga, (0, W - ga.shape[3], 0, H - ga.shape[2])), routed, ties


def _nrp_sums(*terms: torch.Tensor) -> torch.Tensor:
    """Per-channel fp64 sums of the products of ``terms``, (G,)."""
    prod = terms[0].to(torch.float64)
    for t in terms[1:]:
        prod = prod * t.to(torch.float64)
    return prod.sum(dim=(0, 2, 3))


def _nrp_stats(z: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(μ, rstd) (2, G) of z + b over (M, H, W), as the kernels take them:
    fp64 sums of y − y[0] and its square, then μ and rstd in fp64, rounded
    to z's dtype."""
    M, G, H, W = z.shape
    y = z + _nrp_chan(bias)
    shift = y[0, :, 0, 0].to(torch.float64)
    d = y.to(torch.float64) - _nrp_chan(shift)
    n = M * H * W
    mean = d.sum(dim=(0, 2, 3)) / n
    var = (d.square().sum(dim=(0, 2, 3)) / n - mean.square()).clamp_min(0.0)
    # the epsilon as z's dtype holds it, as torch adds it in that dtype
    eps = torch.tensor(NORM_EPS, dtype=z.dtype).item()
    return torch.stack([shift + mean, torch.rsqrt(var + eps)]).to(z.dtype)


def norm_relu_pool_forward_reference(form: NormForm, tensors
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward of ``form`` on ``tensors``, the flat
    (z, bias, gamma, beta) of each branch: ``(out, stats)``. out is act(a),
    a = Σ_k γ_k·(z_k + b_k − μ_k)·rstd_k + β_k, (M, G, H, W), or its 2×2
    max (M, G, H/2, W/2) with the pool; stats (2·branches, G) is each
    branch's (μ, rstd) (:func:`_nrp_stats`)."""
    stats = torch.cat([_nrp_stats(z, b)
                       for z, b, _, _ in _nrp_branches(tensors)])
    h = _nrp_act(form, _nrp_summed(tensors, stats)[1])
    return (_nrp_windows(h).amax(dim=(3, 5)) if form.pool else h), stats


def norm_relu_pool_backward_reference(form: NormForm, tensors, stats,
                                      g_out):
    """Plain version of the backward: ``(grads, sums)``, grads the flat
    (g_z, g_b, g_gamma, g_beta) of each branch. With ga the routed g_out
    (:func:`_nrp_route`), A = Σga and S_k = Σga·x_k per channel: g_z_k =
    γ_k·rstd_k·(ga − A/N − x_k·S_k/N), g_gamma_k = S_k, g_beta_k = A, g_b_k =
    0 (the output does not depend on b); sums (2·branches, G) fp64 = each
    branch's (A, S_k) for the double backward."""
    M, G, H, W = tensors[0].shape
    n = M * H * W
    xs, a = _nrp_summed(tensors, stats)
    ga = _nrp_route(form, a, g_out)[0]
    A = _nrp_sums(ga)
    grads, sums = [], []
    for k, ((z, b, g, _), x) in enumerate(zip(_nrp_branches(tensors), xs)):
        S = _nrp_sums(ga, x)
        gr = g.to(torch.float64) * stats[2 * k + 1].to(torch.float64)
        k1, k2, k3 = (_nrp_chan(c.to(z.dtype)) for c in (gr, -gr * S / n,
                                                         -gr * A / n))
        grads += [k1 * ga + k2 * x + k3, torch.zeros_like(b), S.to(z.dtype),
                  A.to(z.dtype)]
        sums += [A, S]
    return tuple(grads), torch.stack(sums)


def norm_relu_pool_double_backward_reference(form: NormForm, tensors, stats,
                                             g_out, sums, cots):
    """Plain version of the double backward: ``(cs, c_gout)``, cs the flat
    cotangents (c_z, c_b, c_gamma, c_beta) of each branch's inputs to the
    backward, c_gout g_out's, given ``cots``, the flat cotangents (v_z,
    v_b, v_gamma, v_beta) of each branch's outputs (None is zero; g_b is
    identically 0 and takes none). μ and rstd are differentiated as
    functions of z; act' and the routing are piecewise constant, so c_beta =
    c_b = 0 and the branches meet only in ga and c_gout. Per branch and
    channel, V = Σv_z, VX = Σv_z·x, VG = Σv_z·ga and the backward's A and S
    (``sums``) give the coefficients of ``csrc/norm_relu_pool.cu``'s
    ``grad2_finalize``; c_gout is the routing's transpose of act'(a) times
    the branches' summed terms."""
    M, G, H, W = tensors[0].shape
    n = M * H * W
    f64 = torch.float64
    xs, a = _nrp_summed(tensors, stats)
    ga, routed, ties = _nrp_route(form, a, g_out)
    cs, w = [], None
    for k, ((z, b, gamma, beta), x) in enumerate(
            zip(_nrp_branches(tensors), xs)):
        v_z, _, v_gamma, v_beta = cots[4 * k:4 * k + 4]
        if v_z is None:
            v_z = torch.zeros_like(z)
        Vs, VX, VG = _nrp_sums(v_z), _nrp_sums(v_z, x), _nrp_sums(v_z, ga)
        A, S = sums[2 * k], sums[2 * k + 1]
        r, g = stats[2 * k + 1].to(f64), gamma.to(f64)
        gr = g * r
        vg = 0.0 if v_gamma is None else v_gamma.to(f64)
        vb = 0.0 if v_beta is None else v_beta.to(f64)
        qq = VG - A * Vs / n - S * VX / n
        mean_p = -gr * (A * VX + Vs * S) / n ** 2 + vg * A / n
        mean_px = -2.0 * gr * S * VX / n ** 2 + vg * S / n
        ag, av, ax, a0, wv, wx, w0 = (
            _nrp_chan(c.to(z.dtype)) for c in (
                r * (vg - gr * VX / n), -gr * r * S / n,
                -r * mean_px - g * qq * r * r / n, -r * mean_p, gr,
                vg - gr * VX / n, vb - gr * Vs / n))
        cs += [ag * ga + av * v_z + ax * x + a0, torch.zeros_like(b),
               (r * qq).to(z.dtype), torch.zeros_like(beta)]
        term = wv * v_z + wx * x + w0
        w = term if w is None else w + term
    if not form.pool:
        return tuple(cs), _nrp_sloped(form, a, w)
    w = _nrp_windows(w)
    if form.leaky:
        w = _nrp_sloped(form, _nrp_windows(a), w)
    c_gout = torch.where(routed, w, 0.0).sum(dim=(3, 5)) / ties[:, :, :, 0, :, 0]
    return tuple(cs), c_gout


# the kernels' tensors of a branch, in the order of csrc's Branch
_NRP_SLOTS = ("z", "bias", "gamma", "beta", "stats", "sums", "coef", "v_z",
              "v_gamma", "v_beta", "d_z", "d_gamma", "d_beta", "d_b")


@functools.lru_cache(maxsize=None)
def _nrp_library():
    from fumi_tpu_torch.ops import _build
    lib = _build.load("norm_relu_pool")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.norm_relu_pool_forward_launch,
               lib.norm_relu_pool_backward_launch,
               lib.norm_relu_pool_double_backward_launch):
        fn.argtypes = [i32, i32, i32, ptr, ptr, i64] + [i32] * 6 + [ptr]
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _nrp_launch(form: NormForm, who: str, entry: str, branches, g_out,
                out, z: torch.Tensor):
    """One launch of an entry point of ``csrc/norm_relu_pool.cu``:
    ``branches`` holds each branch's tensors by the names of
    :data:`_NRP_SLOTS` (a missing one is a null pointer), ``g_out`` and
    ``out`` the shared ones (None: null); then its scratch and the
    geometry."""
    M, G, H, W = z.shape
    acts = [t for br in branches for t in (br.get("z"), br.get("v_z"),
                                           br.get("d_z"))]
    aligned = all(t.data_ptr() % 16 == 0 for t in acts + [g_out, out]
                  if t is not None)
    plan = norm_relu_pool_plan(G, aligned, _sm_count(z.device.index))
    partial = torch.empty((plan.rows * 3 * form.branches * G,),
                          dtype=torch.float64, device=z.device)
    tensors = [br.get(s) for br in branches for s in _NRP_SLOTS] + [g_out,
                                                                    out]
    table = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = getattr(_nrp_library(), entry)(
        int(form.leaky), int(form.pool), form.branches, table,
        partial.data_ptr(), M, G, H, W, plan.vec, plan.tx, plan.rows, stream)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed with CUDA error {err} "
                           f"(shape {tuple(z.shape)}; {plan})")
    _NRP_OPS[form].launches += 1


def _nrp_channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _nrp_empty_like_nhwc(M, G, H, W, like: torch.Tensor) -> torch.Tensor:
    """An empty (M, G, H, W) fp32 tensor in channels_last memory."""
    return torch.empty((M, H, W, G), dtype=torch.float32,
                       device=like.device).permute(0, 3, 1, 2)


def _nrp_out_shape(form: NormForm, z: torch.Tensor) -> Tuple[int, ...]:
    M, G, H, W = z.shape
    return (M, G, H // 2, W // 2) if form.pool else (M, G, H, W)


def _nrp_inputs(tensors, stats) -> list:
    """Each branch's inputs and statistics for a launch."""
    return [dict(z=z, bias=b, gamma=g, beta=be, stats=stats[2 * k])
            for k, (z, b, g, be) in enumerate(_nrp_branches(tensors))]


def _nrp_outputs(branch: dict) -> list:
    """A branch's outputs (g_z, g_b, g_gamma, g_beta or the cotangents c_),
    allocated into ``branch`` as the kernels' d_ tensors."""
    z, gamma = branch["z"], branch["gamma"]
    branch.update(d_z=_nrp_empty_like_nhwc(*z.shape, z),
                  d_b=torch.empty_like(gamma), d_gamma=torch.empty_like(gamma),
                  d_beta=torch.empty_like(gamma))
    return [branch["d_z"], branch["d_b"], branch["d_gamma"], branch["d_beta"]]


def _nrp_forward(form: NormForm, tensors):
    z = tensors[0]
    if z.device.type == "cpu":
        return norm_relu_pool_forward_reference(form, tensors)
    out = _nrp_empty_like_nhwc(*_nrp_out_shape(form, z), z)
    stats = torch.empty((2 * form.branches, z.shape[1]), dtype=torch.float32,
                        device=z.device)
    _nrp_launch(form, _NRP_OPS[form].__name__, "norm_relu_pool_forward_launch",
                _nrp_inputs(tensors, stats), None, out, z)
    return out, stats


def _nrp_backward(form: NormForm, tensors, stats, g_out):
    z = tensors[0]
    if z.device.type == "cpu":
        return norm_relu_pool_backward_reference(form, tensors, stats, g_out)
    G, nb = z.shape[1], form.branches
    sums = torch.empty((2 * nb, G), dtype=torch.float64, device=z.device)
    coef = torch.empty((nb, 3, G), dtype=torch.float32, device=z.device)
    branches, grads = _nrp_inputs(tensors, stats), []
    for k, br in enumerate(branches):
        br.update(sums=sums[2 * k], coef=coef[k])
        grads += _nrp_outputs(br)
    _nrp_launch(form, f"{_NRP_OPS[form].__name__} backward",
                "norm_relu_pool_backward_launch", branches,
                _nrp_channels_last(g_out), None, z)
    return tuple(grads), sums


def _nrp_double_backward(form: NormForm, tensors, stats, g_out, sums, cots):
    z = tensors[0]
    if z.device.type == "cpu":
        return norm_relu_pool_double_backward_reference(
            form, tensors, stats, g_out, sums, cots)
    coef = torch.empty((form.branches, 7, z.shape[1]), dtype=torch.float32,
                       device=z.device)
    branches, cs = _nrp_inputs(tensors, stats), []
    for k, br in enumerate(branches):
        v_z, _, v_gamma, v_beta = cots[4 * k:4 * k + 4]
        br.update(sums=sums[2 * k], coef=coef[k],
                  v_z=None if v_z is None else _nrp_channels_last(v_z),
                  v_gamma=None if v_gamma is None else v_gamma.contiguous(),
                  v_beta=None if v_beta is None else v_beta.contiguous())
        cs += _nrp_outputs(br)
    c_gout = _nrp_empty_like_nhwc(*_nrp_out_shape(form, z), z)
    _nrp_launch(form, f"{_NRP_OPS[form].__name__} double backward",
                "norm_relu_pool_double_backward_launch", branches,
                _nrp_channels_last(g_out), c_gout, z)
    return tuple(cs), c_gout


class _NormReluPool(torch.autograd.Function):
    """The op of a :class:`NormForm` on the flat (z, b, γ, β) of its
    branches; its backward is :class:`_NormReluPoolBackward`, recorded under
    ``create_graph=True`` so that second-order MAML differentiates it."""

    @staticmethod
    def forward(ctx, form, *tensors):
        out, stats = _nrp_forward(form, tensors)
        ctx.form = form
        ctx.save_for_backward(*tensors, stats)
        return out

    @staticmethod
    def backward(ctx, g_out):
        return (None,) + _NormReluPoolBackward.apply(
            ctx.form, *ctx.saved_tensors, g_out)


class _NormReluPoolBackward(torch.autograd.Function):
    """(z, b, γ, β of each branch, stats, g_out) -> (g_z, g_b, g_γ, g_β of
    each branch); its own backward is the double backward (third order is
    never taken). ``stats`` is saved by the forward and takes no gradient:
    the double backward differentiates μ and rstd through z itself."""

    @staticmethod
    def forward(ctx, form, *args):
        ctx.set_materialize_grads(False)
        *tensors, stats, g_out = args
        grads, sums = _nrp_backward(form, tensors, stats, g_out)
        ctx.form = form
        ctx.save_for_backward(*tensors, stats, g_out, sums)
        return grads

    @staticmethod
    @once_differentiable
    def backward(ctx, *cots):
        *tensors, stats, g_out, sums = ctx.saved_tensors
        cs, c_gout = _nrp_double_backward(ctx.form, tensors, stats, g_out,
                                          sums, cots)
        return (None,) + cs + (None, c_gout)


def _check_norm(who: str, tensors) -> None:
    z = tensors[0]
    if z.dim() != 4 or z.shape[2] < 2 or z.shape[3] < 2:
        raise ValueError(f"{who} takes (M, G, H, W) with H, W >= 2, got "
                         f"shape {tuple(z.shape)}")
    G = z.shape[1]
    dtypes = (torch.float32,) if z.device.type == "cuda" else (
        torch.float32, torch.float64)
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who} runs on cuda or cpu, not {z.device}")
    if z.dtype not in dtypes:
        raise TypeError(f"{who} on {z.device.type} computes "
                        f"{', '.join(map(str, dtypes))}, got {z.dtype}")
    for zk, *params in _nrp_branches(tensors):
        if zk.shape != z.shape or zk.dtype != z.dtype or \
                zk.device != z.device:
            raise ValueError(f"{who}: every branch must be {tuple(z.shape)} "
                             f"{z.dtype} on {z.device}, got "
                             f"{tuple(zk.shape)} {zk.dtype} on {zk.device}")
        for name, t in zip(("bias", "gamma", "beta"), params):
            if tuple(t.shape) != (G,) or t.dtype != z.dtype or \
                    t.device != z.device:
                raise ValueError(f"{who}: {name} must be ({G},) {z.dtype} "
                                 f"on {z.device}, got {tuple(t.shape)} "
                                 f"{t.dtype} on {t.device}")


def _norm_op(form: NormForm, tensors) -> torch.Tensor:
    _check_norm(_NRP_OPS[form].__name__, tensors)
    if tensors[0].device.type == "cuda":
        tensors = [_nrp_channels_last(t) if t.dim() == 4 else t.contiguous()
                   for t in tensors]
    return _NormReluPool.apply(form, *tensors)


@spanned
def norm_relu_pool(z: torch.Tensor, bias: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor) -> torch.Tensor:
    """``maxpool2x2(relu(batch_stat_norm(z, p)))`` of conv4's block as one
    op: z (M, G, H, W), bias, gamma, beta (G,); returns (M, G, H/2, W/2)
    in channels_last memory. Differentiable twice: its backward is an
    autograd Function too, whose backward (the double backward) is
    once-differentiable. A CUDA fp32 z launches ``csrc/norm_relu_pool.cu``
    (z taken in channels_last memory), three kernels for each of the
    forward, backward and double backward, ``launches`` counting each of
    those calls; a CPU z (fp32 or fp64) runs the plain versions."""
    return _norm_op(RELU_POOL, (z, bias, gamma, beta))


@spanned
def norm_leaky_relu(z: torch.Tensor, bias: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor) -> torch.Tensor:
    """``leaky_relu(batch_stat_norm(z, p), 0.1)`` of resnet12's units c1
    and c2 as one op, :func:`norm_relu_pool`'s leaky form without the
    pool: (M, G, H, W) out in channels_last memory; differentiable twice,
    on the same kernels and plain versions, ``launches`` its own."""
    return _norm_op(LEAKY, (z, bias, gamma, beta))


@spanned
def norm_residual_pool(z: torch.Tensor, bias: torch.Tensor,
                       gamma: torch.Tensor, beta: torch.Tensor,
                       z_sc: torch.Tensor, bias_sc: torch.Tensor,
                       gamma_sc: torch.Tensor, beta_sc: torch.Tensor
                       ) -> torch.Tensor:
    """``maxpool2x2(leaky_relu(batch_stat_norm(z, p) + batch_stat_norm(z_sc,
    p_sc), 0.1))`` of resnet12's unit c3 and its stage's shortcut as one
    op, :func:`norm_relu_pool`'s leaky form of two branches: z and z_sc (M,
    G, H, W) -> (M, G, H/2, W/2) in channels_last memory; differentiable
    twice, on the same kernels and plain versions, ``launches`` its own."""
    return _norm_op(LEAKY_SUM_POOL, (z, bias, gamma, beta, z_sc, bias_sc,
                                     gamma_sc, beta_sc))


norm_relu_pool.launches = 0
norm_leaky_relu.launches = 0
norm_residual_pool.launches = 0
# each form's wrapper, whose ``launches`` its launches count
_NRP_OPS = {RELU_POOL: norm_relu_pool, LEAKY: norm_leaky_relu,
            LEAKY_SUM_POOL: norm_residual_pool}


# ---------------------------------------------------------------------------
# conv4's and resnet12's 3x3 convolutions (csrc/conv3x3.cu)
# ---------------------------------------------------------------------------

# csrc/conv3x3.cu's fixed tiles: output channels a fprop/dgrad block (kTN);
# a wgrad chunk's gy pixels and x slots (kWP, kWX); a narrow wgrad chunk's
# pixels (kNP)
_CONV_TN, _CONV_WP, _CONV_WX, _CONV_NP = 64, 48, 96, 64
# blocks an SM holds of a 128-pixel fprop/dgrad or of a wgrad (registers
# and shared memory: 55 KB and 74 KB); the fewest chunks a wgrad split
# walks, and the most: a split's partial is one fp32 sum over its chunks'
# positions, whose rounding grows with its length, and wide channel tiles
# (a few splits of many tiles) leave the last wave of blocks mostly empty
_CONV_RESIDENT, _CONV_MIN_CHUNKS, _CONV_MAX_CHUNKS = 2, 4, 160
CONV3X3_KINDS = ("fprop", "dgrad", "wgrad")


class Conv3x3Plan(NamedTuple):
    """How ``csrc/conv3x3.cu`` covers one call: ``tile_m`` output pixels a
    fprop/dgrad block; a wgrad's ``splits`` blocks along the positions
    (each one partial, summed in a fixed order by a second launch), and,
    where C_in % 4 == 0, ``rows`` image-row pieces of ``piece`` pixels a
    chunk."""
    tile_m: int
    splits: int
    rows: int
    piece: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv3x3_supported(cin: int, cout: int) -> bool:
    """Whether the kernels take C_in and C_out channels a group: C_out a
    multiple of 4 (16-byte rows of gy), C_in a multiple of 4 or at most 3
    (the narrow kernels, block 0's images)."""
    return cin >= 1 and cout >= 1 and cout % 4 == 0 and (
        cin % 4 == 0 or cin <= 3)


def conv3x3_plan(kind: str, M: int, H: int, W: int, G: int, cin: int,
                 cout: int, sms: int) -> Conv3x3Plan:
    """The plan of a ``kind`` call (fprop, dgrad or wgrad) over M images of
    H x W, G groups of ``cin`` -> ``cout`` channels, on a card of ``sms``
    SMs; raises ValueError on what the kernels do not take.

    fprop/dgrad: 128-pixel tiles where they make a wave of the card
    (``_CONV_RESIDENT`` blocks an SM), 64 below. wgrad: enough splits of the
    positions for two such waves over the output tiles, each walking at
    least ``_CONV_MIN_CHUNKS`` chunks where there are so many, and at most
    ``_CONV_MAX_CHUNKS``; a chunk is 64 pixels (C_in <= 3), else one row of
    up to 48 pixels (a longer row in pieces) or as many whole short rows as
    fit."""
    if kind not in CONV3X3_KINDS:
        raise ValueError(f"conv3x3_plan: kind is one of {CONV3X3_KINDS}, "
                         f"got {kind!r}")
    if min(M, H, W, G) < 1 or not conv3x3_supported(cin, cout):
        raise ValueError(
            f"conv3x3 {kind} takes C_out a multiple of 4 and C_in a multiple "
            f"of 4 or at most 3 a group, got M={M} H={H} W={W} G={G} "
            f"C_in={cin} C_out={cout}")
    P = M * H * W
    if kind != "wgrad":
        n = cout if kind == "fprop" else cin
        blocks = _cdiv(P, 128) * G * _cdiv(n, _CONV_TN)
        return Conv3x3Plan(128 if blocks >= _CONV_RESIDENT * sms else 64,
                           1, 1, 1)
    target = 2 * _CONV_RESIDENT * sms
    if cin <= 3:
        rows = piece = 1
        chunks = _cdiv(P, _CONV_NP)
        tiles = G * _cdiv(cout, 64)
    else:
        piece = min(W, _CONV_WP)
        rows = max(1, min(_CONV_WP // piece, _CONV_WX // (piece + 2))) \
            if piece == W else 1
        chunks = _cdiv(M * H * _cdiv(W, piece), rows)
        tiles = 3 * G * _cdiv(cout, 64) * _cdiv(cin, 64)
    splits = max(min(_cdiv(chunks, _CONV_MIN_CHUNKS), _cdiv(target, tiles)),
                 _cdiv(chunks, _CONV_MAX_CHUNKS))
    return Conv3x3Plan(0, splits, rows, piece)


def _conv_patches(x: torch.Tensor) -> torch.Tensor:
    """(M, C, H, W) -> (M, C, 9, H, W): each pixel's 3x3 window, tap 3r + s,
    zero outside the image."""
    H, W = x.shape[2], x.shape[3]
    xp = F.pad(x, (1, 1, 1, 1))
    return torch.stack([xp[:, :, r:r + H, s:s + W] for r in range(3)
                        for s in range(3)], dim=2)


def conv3x3_fprop_reference(x: torch.Tensor, w: torch.Tensor,
                            groups: int) -> torch.Tensor:
    """Plain version of the forward: y (M, G·C_out, H, W) of x (M, G·C_in,
    H, W) and w (G·C_out, C_in, 3, 3), a stride-1 SAME grouped convolution
    written out as the windows' products."""
    M, _, H, W = x.shape
    G, cin, cout = groups, w.shape[1], w.shape[0] // groups
    patches = _conv_patches(x).reshape(M, G, cin, 9, H, W)
    y = torch.einsum("mgckhw,gnck->mgnhw", patches,
                     w.reshape(G, cout, cin, 9))
    return y.reshape(M, G * cout, H, W)


def conv3x3_dgrad_reference(g: torch.Tensor, w: torch.Tensor,
                            groups: int) -> torch.Tensor:
    """Plain version of the input gradient: dx (M, G·C_in, H, W) of gy (M,
    G·C_out, H, W) through w, the forward with the window turned by 180°
    and the channel roles swapped."""
    G, cin, cout = groups, w.shape[1], w.shape[0] // groups
    turned = w.reshape(G, cout, cin, 9).flip(-1).transpose(1, 2)
    return conv3x3_fprop_reference(g, turned.reshape(G * cin, cout, 3, 3), G)


def conv3x3_wgrad_reference(x: torch.Tensor, g: torch.Tensor,
                            groups: int) -> torch.Tensor:
    """Plain version of the weight gradient: dw (G·C_out, C_in, 3, 3), each
    tap's x window times gy summed over every pixel."""
    M, _, H, W = x.shape
    G, cin, cout = groups, x.shape[1] // groups, g.shape[1] // groups
    patches = _conv_patches(x).reshape(M, G, cin, 9, H, W)
    dw = torch.einsum("mgckhw,mgnhw->gnck", patches,
                      g.reshape(M, G, cout, H, W))
    return dw.reshape(G * cout, cin, 3, 3)


@functools.lru_cache(maxsize=None)
def _conv_library():
    from fumi_tpu_torch.ops import _build
    lib = _build.load("conv3x3")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.conv3x3_fprop_launch, lib.conv3x3_dgrad_launch):
        fn.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
        fn.restype = i32
    lib.conv3x3_wgrad_launch.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
    lib.conv3x3_wgrad_launch.restype = i32
    lib.conv3x3_wgrad_partial_floats.argtypes = [i32] * 3
    lib.conv3x3_wgrad_partial_floats.restype = ctypes.c_longlong
    return lib


def _conv_nhwc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in channels_last memory at a 16-byte aligned address."""
    t = t.contiguous(memory_format=torch.channels_last)
    if t.data_ptr() % 16:
        t = torch.empty_like(t, memory_format=torch.channels_last).copy_(t)
    return t


def _conv_launch(kind: str, a: torch.Tensor, b: torch.Tensor,
                 groups: int) -> torch.Tensor:
    """One call of an entry point of ``csrc/conv3x3.cu``: fprop (x, w),
    dgrad (gy, w) or wgrad (x, gy)."""
    G = groups
    a = _conv_nhwc(a)
    b = _conv_nhwc(b) if kind == "wgrad" else b.contiguous()
    M, _, H, W = a.shape
    if kind == "wgrad":
        cin, cout = a.shape[1] // G, b.shape[1] // G
        out = torch.empty((G * cout, cin, 3, 3), dtype=a.dtype,
                          device=a.device)
    else:
        cin, cout = b.shape[1], b.shape[0] // G
        n = cout if kind == "fprop" else cin
        out = torch.empty((M, H, W, G * n), dtype=a.dtype,
                          device=a.device).permute(0, 3, 1, 2)
    plan = conv3x3_plan(kind, M, H, W, G, cin, cout, _sm_count(a.device.index))
    lib = _conv_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if kind == "wgrad":
        part = torch.empty(
            (plan.splits * lib.conv3x3_wgrad_partial_floats(G, cin, cout),),
            dtype=a.dtype, device=a.device)
        err = lib.conv3x3_wgrad_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(), M, H,
            W, G, cin, cout, plan.splits, plan.rows, plan.piece, stream)
    else:
        # the weight packed for the main loop (the narrow forward reads it
        # where it lies)
        wp = None if kind == "fprop" and cin <= 3 else torch.empty(
            (b.numel(),), dtype=a.dtype, device=a.device)
        fn = (lib.conv3x3_fprop_launch if kind == "fprop"
              else lib.conv3x3_dgrad_launch)
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if wp is None else wp.data_ptr(), out.data_ptr(), M, H,
                 W, G, cin, cout, plan.tile_m, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 {kind} kernel launch failed with CUDA "
                           f"error {err} (shapes {tuple(a.shape)}, "
                           f"{tuple(b.shape)}, groups {G}; {plan})")
    _CONV_ENTRY[kind].launches += 1
    return out


_CONV_REFERENCE = {"fprop": conv3x3_fprop_reference,
                   "dgrad": conv3x3_dgrad_reference,
                   "wgrad": conv3x3_wgrad_reference}


def _conv(kind: str, a: torch.Tensor, b: torch.Tensor,
          groups: int) -> torch.Tensor:
    if a.device.type == "cpu":
        return _CONV_REFERENCE[kind](a, b, groups)
    return _conv_launch(kind, a, b, groups)


class _Conv3x3Fprop(torch.autograd.Function):
    """y = fprop(x, w); bilinear, so its backward is the other two entry
    points: g_x = dgrad(gy, w), g_w = wgrad(x, gy)."""

    @staticmethod
    def forward(ctx, x, w, groups):
        ctx.save_for_backward(x, w)
        ctx.groups = groups
        return _conv("fprop", x, w, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        G = ctx.groups
        gx = _Conv3x3Dgrad.apply(gy, w, G) if ctx.needs_input_grad[0] else None
        gw = _Conv3x3Wgrad.apply(x, gy, G) if ctx.needs_input_grad[1] else None
        return gx, gw, None


class _Conv3x3Dgrad(torch.autograd.Function):
    """dx = dgrad(g, w); with c the cotangent of dx: g_g = fprop(c, w),
    g_w = wgrad(c, g)."""

    @staticmethod
    def forward(ctx, g, w, groups):
        ctx.save_for_backward(g, w)
        ctx.groups = groups
        return _conv("dgrad", g, w, groups)

    @staticmethod
    def backward(ctx, c):
        g, w = ctx.saved_tensors
        G = ctx.groups
        gg = _Conv3x3Fprop.apply(c, w, G) if ctx.needs_input_grad[0] else None
        gw = _Conv3x3Wgrad.apply(c, g, G) if ctx.needs_input_grad[1] else None
        return gg, gw, None


class _Conv3x3Wgrad(torch.autograd.Function):
    """dw = wgrad(x, g); with c the cotangent of dw: g_x = dgrad(g, c),
    g_g = fprop(x, c)."""

    @staticmethod
    def forward(ctx, x, g, groups):
        ctx.save_for_backward(x, g)
        ctx.groups = groups
        return _conv("wgrad", x, g, groups)

    @staticmethod
    def backward(ctx, c):
        x, g = ctx.saved_tensors
        G = ctx.groups
        gx = _Conv3x3Dgrad.apply(g, c, G) if ctx.needs_input_grad[0] else None
        gg = _Conv3x3Fprop.apply(x, c, G) if ctx.needs_input_grad[1] else None
        return gx, gg, None


def _check_conv3x3(kind: str, a: torch.Tensor, b: torch.Tensor,
                   groups: int) -> None:
    """fprop (x, w), dgrad (gy, w) or wgrad (x, gy): activations (M, G·C,
    H, W), the weight (G·C_out, C_in, 3, 3); one device and dtype, fp32 on
    a card, fp32 or fp64 on the CPU; channel counts the kernels take."""
    who = "conv3x3_" + kind
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who} runs on cuda or cpu, not {a.device}")
    dtypes = (torch.float32,) if a.device.type == "cuda" else (
        torch.float32, torch.float64)
    if a.dtype not in dtypes or b.dtype != a.dtype or b.device != a.device:
        raise TypeError(f"{who} on {a.device.type} computes "
                        f"{', '.join(map(str, dtypes))} on one device, got "
                        f"{a.dtype} on {a.device} and {b.dtype} on "
                        f"{b.device}")
    G = groups
    ok = a.dim() == 4 and b.dim() == 4 and G >= 1
    if ok and kind == "wgrad":
        ok = a.shape[0] == b.shape[0] and a.shape[2:] == b.shape[2:] and \
            a.shape[1] % G == 0 and b.shape[1] % G == 0
        cin, cout = a.shape[1] // G, b.shape[1] // G
    elif ok:
        cin, cout = b.shape[1], b.shape[0] // G
        ok = b.shape[0] % G == 0 and tuple(b.shape[2:]) == (3, 3) and \
            a.shape[1] == G * (cin if kind == "fprop" else cout)
    if not ok or not conv3x3_supported(cin, cout):
        raise ValueError(f"{who}: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} at groups {G} are not a 3x3 "
                         f"convolution the kernels take (C_out a multiple of "
                         f"4, C_in a multiple of 4 or at most 3)")


@spanned
def conv3x3_fprop(x: torch.Tensor, w: torch.Tensor,
                  groups: int = 1) -> torch.Tensor:
    """A stride-1 SAME 3x3 grouped convolution, ``F.conv2d(x, w, padding=1,
    groups=groups)`` without bias: x (M, G·C_in, H, W), w (G·C_out, C_in,
    3, 3) -> (M, G·C_out, H, W) in channels_last memory. Differentiable to
    any order: its backward is :func:`conv3x3_dgrad` and
    :func:`conv3x3_wgrad`, whose backwards are again the three. A CUDA fp32
    x launches ``csrc/conv3x3.cu`` (``launches`` counts each call of this
    entry point, the backwards' too); a CPU x (fp32 or fp64) runs
    :func:`conv3x3_fprop_reference`."""
    _check_conv3x3("fprop", x, w, groups)
    return _Conv3x3Fprop.apply(x, w, groups)


@spanned
def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor,
                  groups: int = 1) -> torch.Tensor:
    """The input gradient of :func:`conv3x3_fprop` through w: gy (M,
    G·C_out, H, W) -> dx (M, G·C_in, H, W); differentiable, as the
    forward. Plain version: :func:`conv3x3_dgrad_reference`."""
    _check_conv3x3("dgrad", g, w, groups)
    return _Conv3x3Dgrad.apply(g, w, groups)


@spanned
def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor,
                  groups: int = 1) -> torch.Tensor:
    """The weight gradient of :func:`conv3x3_fprop`: x (M, G·C_in, H, W)
    and gy (M, G·C_out, H, W) -> dw (G·C_out, C_in, 3, 3); differentiable,
    as the forward. A card runs two kernels, the partials of the plan's
    splits of the positions and their sum. Plain version:
    :func:`conv3x3_wgrad_reference`."""
    _check_conv3x3("wgrad", x, g, groups)
    return _Conv3x3Wgrad.apply(x, g, groups)


conv3x3_fprop.launches = 0
conv3x3_dgrad.launches = 0
conv3x3_wgrad.launches = 0
_CONV_ENTRY = {"fprop": conv3x3_fprop, "dgrad": conv3x3_dgrad,
               "wgrad": conv3x3_wgrad}
