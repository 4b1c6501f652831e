"""The port's CUDA kernels and their plain PyTorch versions.

The counterparts of ``fumi_tpu/ops/pallas_kernels.py``:

- :func:`fused_adapt` (``fused_maml_adapt`` / ``fused_fumi_adapt``): the
  eval protocol runs 100 SGD adaptation steps per task, a long chain of
  small dependent products. One launch of ``csrc/fused_adapt.cu`` runs the
  whole adaptation of the 2-hidden-layer MLP plus its per-task head, and
  the query forward (one thread block per task). Plain version:
  :func:`fused_adapt_reference`, the same hand-derived loop written with
  ``torch.matmul``.
- :func:`gather_rows`: the row gather ``table[idx]`` that assembles each
  episode from the device-resident embedding table
  (``csrc/gather_rows.cu``). Plain version: :func:`gather_rows_reference`.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version. The design and bound of each kernel are in its
source's note. ``<wrapper>.launches`` counts kernel launches, so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence

import torch

from fumi_tpu_torch.models import mlp
from fumi_tpu_torch.models.fumi import im_net_depth

# The fused kernel wins from this horizon on. 8 is the crossover measured
# on a TPU against the scan engine; it stays until an H100 measurement
# replaces it (PERF.md, open questions).
MIN_FUSED_STEPS = 8


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


def _launch(lib, w1, b1, w2, b2, head_w, head_b, support_x, support_y,
            query_x, dims, n_steps, step_size):
    B, S, Qn, D, H1, H2, N = dims
    out = torch.empty((B, Qn, N), dtype=torch.float32, device=support_x.device)
    scratch = torch.empty(
        (B * lib.fused_adapt_scratch_floats(D, H1, H2, N),),
        dtype=torch.float32, device=support_x.device)
    stream = torch.cuda.current_stream(support_x.device).cuda_stream
    ptrs = [t.data_ptr() for t in (support_x, support_y, query_x, w1, b1, w2,
                                   b2, head_w, head_b, out, scratch)]
    err = lib.fused_adapt_launch(*ptrs, B, S, Qn, D, H1, H2, N,
                                 int(n_steps), float(step_size), stream)
    if err != 0:
        smem = lib.fused_adapt_smem_bytes(S, H1, H2, N)
        raise RuntimeError(
            f"fused_adapt kernel launch failed with CUDA error {err} "
            f"(B={B} S={S} Qn={Qn} D={D} H1={H1} H2={H2} N={N}; needs "
            f"{smem} bytes of shared memory)")
    return out


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signatures declared."""
    from fumi_tpu_torch.ops import _build
    lib = _build.load("fused_adapt")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_adapt_launch.argtypes = (
        [ptr] * 11 + [i32] * 8 + [ctypes.c_float, ptr])
    lib.fused_adapt_launch.restype = i32
    lib.fused_adapt_smem_bytes.argtypes = [i32] * 4
    lib.fused_adapt_smem_bytes.restype = ctypes.c_longlong
    lib.fused_adapt_scratch_floats.argtypes = [i32] * 4
    lib.fused_adapt_scratch_floats.restype = ctypes.c_longlong
    return lib


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
    (B, Qn, N) fp32. CUDA tensors launch the kernel; CPU tensors run
    :func:`fused_adapt_reference`."""
    tensors = (w1, b1, w2, b2, head_w, head_b, support_x, support_y, query_x)
    dims = _check(*tensors)
    dev = support_x.device
    if dev.type == "cpu":
        return fused_adapt_reference(*tensors, n_steps, step_size)
    if dev.type != "cuda":
        raise ValueError(f"fused_adapt runs on cuda or cpu, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_adapt takes contiguous tensors")
    out = _launch(_library(), *tensors, dims, n_steps, step_size)
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


def fused_maml_adapt(params: Dict[str, torch.Tensor], support_x, support_y,
                     query_x, n_steps: int, step_size: float) -> torch.Tensor:
    """MAML form of :func:`fused_adapt`: ``params`` is the MLP state dict
    (2 hidden layers); its head broadcasts across tasks."""
    names = mlp.layer_names(params)
    if len(names) != 3:
        raise ValueError("fused kernel supports exactly 2 hidden layers")
    B = support_x.shape[0]
    w3, b3 = params["net.lin_final.weight"], params["net.lin_final.bias"]
    N = w3.shape[0]
    head_w = w3.expand((B,) + tuple(w3.shape)).contiguous()
    head_b = b3.reshape(1, 1, N).expand(B, 1, N).contiguous()
    return fused_adapt(params["net.lin_0.weight"], params["net.lin_0.bias"],
                       params["net.lin_1.weight"], params["net.lin_1.bias"],
                       head_w, head_b, support_x, support_y, query_x,
                       n_steps, step_size)


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
    from fumi_tpu_torch.ops import _build
    lib = _build.load("gather_rows")
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.gather_rows_launch.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.gather_rows_launch.restype = ctypes.c_int
    return lib


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``(R, D)[(M,)] -> (M, D)``, bitwise ``table[idx]``.

    ``table`` is 2-D and contiguous, of any dtype (the kernel copies row
    bytes); ``idx`` is 1-D int32 on the same device. A CUDA table launches
    ``csrc/gather_rows.cu`` (an index outside ``[0, R)`` raises at the next
    synchronisation); a CPU table runs :func:`gather_rows_reference`."""
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"gather_rows takes a contiguous 2-D table, got "
                         f"shape {tuple(table.shape)}"
                         f"{'' if table.is_contiguous() else ', strided'}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"gather_rows takes 1-D int32 indices, got "
                        f"{idx.dtype} of shape {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError(f"gather_rows: table on {table.device}, indices "
                         f"on {idx.device}")
    dev = table.device
    if dev.type == "cpu":
        return gather_rows_reference(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, not {dev}")
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
