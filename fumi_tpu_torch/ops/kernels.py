"""The port's CUDA kernels and their plain PyTorch versions.

The counterparts of ``fumi_tpu/ops/pallas_kernels.py``:

- :func:`fused_adapt` (``fused_maml_adapt`` / ``fused_fumi_adapt``): the
  eval protocol runs 100 SGD adaptation steps per task, a long chain of
  small dependent products. One launch of ``csrc/fused_adapt.cu`` runs the
  whole adaptation of the 2-hidden-layer MLP plus its per-task head, and
  the query forward, each task on one thread-block cluster
  (:func:`fused_adapt_plan`). Plain version: :func:`fused_adapt_reference`,
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

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version. The design and bound of each kernel are in its
source's note. ``<wrapper>.launches`` counts kernel launches, so a run can
show that its main path went through the kernel. While a ``torch.profiler``
runs (``--tpu_profile_dir``), each wrapper's call is a range named after
the wrapper on the trace.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from fumi_tpu_torch.models import mlp
from fumi_tpu_torch.models.fumi import im_net_depth

def _named(fn):
    """``fn`` inside a profiler range of its own name while a profiler
    runs; otherwise ``fn`` with one flag read more."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if torch.autograd._profiler_enabled():
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return fn(*args, **kwargs)
    return wrapper


# The fused kernel wins from this horizon on: on an NVIDIA H100 80GB HBM3
# (700 W) a FuMI request (R=1, 100 queries) took 1.17 ms through the kernel
# at 1 adaptation step against 3.33 ms through the autograd engine, and the
# kernel stayed ahead at 2, 4, 8 and 16 steps (chip_smoke.py, PERF.md).
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


# The launch plan of csrc/fused_adapt.cu. The tile constants and
# _smem_bytes follow the source's kRows, kCols, kUpdK, kMaxCluster and
# layout(); its launch function recomputes the layout and refuses a plan
# that does not match it.
_ROWS, _COLS, _UPD_K = 4, 8, 8
MAX_CLUSTER = 16
# below this many D columns a block, its SM would mostly wait at the
# cluster barriers: the plan takes a smaller cluster instead
MIN_BLOCK_COLS = 32


class FusedAdaptPlan(NamedTuple):
    """How the kernel spreads a task: ``C`` blocks (one cluster) of
    ``cols`` columns of D each, the W1 slice in ``"shared"`` or
    ``"device"`` memory, ``smem_bytes`` of shared memory a block."""
    C: int
    cols: int
    w1: str
    smem_bytes: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _w1_slice_floats(D: int, H1: int, C: int) -> int:
    """One block's k-major W1 slice: its rows padded to whole update
    tiles, its row stride to whole column tiles plus 4."""
    return _round_up(-(-D // C), _UPD_K) * (_round_up(H1, _COLS) + 4)


def _smem_bytes(S, D, H1, H2, N, C, w1_smem: bool) -> int:
    SP, DP = _round_up(S, _ROWS), _round_up(-(-D // C), _UPD_K)
    LH, H2P = _round_up(H1, _COLS) + 4, _round_up(H2, 4)
    HC, JC = _round_up(-(-H1 // C), 4), _round_up(-(-H2 // C), 4)
    sizes = (DP * SP, C * SP * HC, SP * LH, SP * HC, SP * HC, C * SP * JC,
             SP * H2P, SP * N, HC * (H2P + 4), HC, H2P, N * H2P, N, SP,
             _w1_slice_floats(D, H1, C) if w1_smem else 0)
    return 4 * sum(_round_up(n, 4) for n in sizes)


def fused_adapt_plan(dims: Tuple[int, ...], smem_optin: int,
                     max_cluster: int) -> FusedAdaptPlan:
    """The plan for ``dims = (B, S, Qn, D, H1, H2, N)`` on a card whose
    blocks may opt in to ``smem_optin`` bytes of shared memory and which
    schedules clusters of up to ``max_cluster`` blocks of the kernel.

    C is the largest cluster the card schedules (16 at most) that leaves
    each block ``MIN_BLOCK_COLS`` columns of D; a block owns ``cols =
    ceil(D / C)`` of them (the last one fewer where C does not divide D).
    The W1 slice lives in shared memory where it fits beside the
    activations, else in device memory. Raises where not even the
    activations fit."""
    B, S, Qn, D, H1, H2, N = dims
    C = max(1, min(MAX_CLUSTER, max_cluster, D // MIN_BLOCK_COLS))
    for w1 in ("shared", "device"):
        nbytes = _smem_bytes(S, D, H1, H2, N, C, w1 == "shared")
        if nbytes <= smem_optin:
            return FusedAdaptPlan(C, -(-D // C), w1, nbytes)
    raise RuntimeError(
        f"fused_adapt: no launch fits the card (B={B} S={S} Qn={Qn} D={D} "
        f"H1={H1} H2={H2} N={N}): the activations alone need {nbytes} "
        f"bytes of shared memory a block at {C} blocks per task, the card "
        f"gives a block {smem_optin}")


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signatures declared."""
    from fumi_tpu_torch.ops import _build
    lib = _build.load("fused_adapt")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_adapt_launch.argtypes = (
        [ptr] * 11 + [i64] * 2 + [i32] * 10 + [i64, i32, ctypes.c_float, ptr])
    lib.fused_adapt_launch.restype = i32
    lib.fused_adapt_smem_bytes.argtypes = [i32] * 7
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
    scratch = torch.empty(
        (B * plan.C * _w1_slice_floats(D, H1, plan.C)
         if plan.w1 == "device" else 1,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in tensors + (out, scratch)]
    err = _library().fused_adapt_launch(
        *ptrs, *head_strides, B, S, Qn, D, H1, H2, N, plan.C, plan.cols,
        int(plan.w1 == "shared"), plan.smem_bytes, int(n_steps),
        float(step_size), stream)
    if err != 0:
        raise RuntimeError(
            f"{who} kernel launch failed with CUDA error {err} (B={B} S={S} "
            f"Qn={Qn} D={D} H1={H1} H2={H2} N={N}; {plan})")
    return out


@_named
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


@_named
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


@_named
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


@_named
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


@_named
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


@_named
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
