#!/usr/bin/env python3
"""Where the fused adaptation kernel's step goes, measured on the card.

    python3 scripts/fused_adapt_phases.py [--batch 4] [--steps 100]

Writes a copy of ``fumi_tpu_torch/csrc/fused_adapt.cu`` with ``clock64()``
stamps at the phase boundaries of an adaptation step into the git-ignored
``fumi_tpu_torch/build/phases/`` and builds it there; the kernel source has
no switch for this. Thread 0 of block 0 (rank 0 of the first task's
cluster) sums the SM cycles between consecutive boundaries over the steps.
Each cluster barrier gets a ``__syncthreads()`` in front of it, so a
barrier's time is the wait for the slowest block of the cluster. Runs the
flagship shapes (S=25, Qn=100, D=2048, H=(256, 64), N=5) with weights and
episodes drawn from a seed, and prints the card, the cycles a step of each
phase and their sum. Needs one CUDA card and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "fumi_tpu_torch", "csrc", "fused_adapt.cu")

# the boundaries the stamps go after, in the order of the stamps: the
# stages of adapt_step, then the two exchanges of forward_a2
LABELS = ("a1 from G P, r1", "logits", "g", "dr2",
          "dr1 of the own columns, P", "W3, W2, b1, b2, b3 updates",
          "partial a2, pushed", "exchange 1: the partials' arrival",
          "a2 own columns, pushed", "exchange 2: r2's arrival")

HEADER = """
__device__ long long g_phase[64];
__shared__ long long s_phase[64];
__shared__ long long s_last;
#define STAMP(i) do { if (threadIdx.x == 0 && blockIdx.x == 0) { \\
  long long n_ = clock64(); s_phase[i] += n_ - s_last; s_last = n_; } \\
  } while (0)
"""


def instrument(src: str) -> tuple:
    """The stamped source and the number of stamps."""
    count = [0]

    def stamp():
        count[0] += 1
        return f"STAMP({count[0] - 1});"

    def function(name: str, text: str) -> str:
        i = text.index("{", text.index(name + "("))
        depth, j = 0, i
        while True:
            depth += {"{": 1, "}": -1}.get(text[j], 0)
            if depth == 0:
                break
            j += 1
        out = []
        for line in text[i:j].split("\n"):
            s = line.strip()
            top = line.startswith("  ") and not line.startswith("   ")
            if top and (s == "cluster.sync();" or s.startswith("mbar_wait(")):
                out += [f"  __syncthreads(); {stamp()}", line, f"  {stamp()}"]
            elif top and s == "__syncthreads();":
                out += [line, f"  {stamp()}"]
            else:
                out.append(line)
        return text[:i] + "\n".join(out) + text[j:]

    src = function("adapt_step", src)
    # the exchanges of a step are forward_a2's (it also runs for the
    # queries, after the stamps are read)
    i = src.index("__device__ void forward_a2(")
    j = src.index("// sum_s a[s * sa]", i)
    src = src[:i] + function("forward_a2", src[i:j]) + src[j:]
    src = src.replace("namespace {\n", "namespace {\n" + HEADER, 1)
    loop = "    for (int it = 0; it < d.n_steps; ++it)"
    src = src.replace(loop, "    if (threadIdx.x == 0) {\n"
                      "      for (int i = 0; i < 64; ++i) s_phase[i] = 0;\n"
                      "      s_last = clock64();\n    }\n"
                      "    __syncthreads();\n" + loop, 1)
    src = src.replace("  // the queries through the adapted weights",
                      "  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
                      "    for (int i = 0; i < 64; ++i) g_phase[i] = "
                      "s_phase[i];\n"
                      "  // the queries through the adapted weights", 1)
    # the stamps' static shared memory comes off the card's opt-in limit
    src = src.replace("err = set_attributes(*smem_optin);",
                      "*smem_optin -= 1024;\n"
                      "  if (err == cudaSuccess) "
                      "err = set_attributes(*smem_optin);", 1)
    src += ('\nextern "C" int fused_adapt_phases(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_phase, "
            "sizeof(long long) * 64);\n}\n")
    return src, count[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("fused_adapt_phases: needs a CUDA card")
    sys.path.insert(0, HERE)
    from fumi_tpu_torch.models import mlp
    from fumi_tpu_torch.ops import _build, kernels

    with open(SRC) as f:
        src, n = instrument(f.read())
    if n != len(LABELS):
        sys.exit(f"fused_adapt_phases: {n} stamps, {len(LABELS)} labels: "
                 "the kernel's phases changed, update LABELS")
    phases = os.path.join(_build.BUILD_DIR, "phases")
    os.makedirs(phases, exist_ok=True)
    with open(os.path.join(phases, "fused_adapt.cu"), "w") as f:
        f.write(src)
    _build.CSRC, _build.BUILD_DIR = phases, phases
    lib = kernels._library()
    lib.fused_adapt_phases.argtypes = [ctypes.c_void_p]
    for line in _build.build_logs.get("fused_adapt", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    B, S, Qn, D, H1, H2, N = args.batch, 25, 100, 2048, 256, 64, 5
    dev = torch.device("cuda")
    p = {k: v.to(dev) for k, v in
         mlp.init(torch.Generator().manual_seed(0), D, N, (H1, H2)).items()}
    rng = np.random.RandomState(0)
    sx = torch.from_numpy(rng.randn(B, S, D).astype(np.float32)).to(dev)
    qx = torch.from_numpy(rng.randn(B, Qn, D).astype(np.float32)).to(dev)
    sy = torch.from_numpy(np.tile(np.repeat(np.arange(N), S // N),
                                  (B, 1)).astype(np.int32)).to(dev)
    kernels.fused_maml_adapt_batched(p, sx, sy, qx, args.steps, 0.01)
    torch.cuda.synchronize()
    cycles = (ctypes.c_longlong * 64)()
    lib.fused_adapt_phases(cycles)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True,
                           check=True).stdout.split()[0]
    total = sum(cycles[i] for i in range(n)) / args.steps
    print(f"card: {card}; SM clock {clock} MHz after the run")
    print(f"fused_adapt phases, B={B} S={S} D={D} H=({H1},{H2}) N={N}, "
          f"{args.steps} steps; SM cycles a step, block 0:")
    for i, label in enumerate(LABELS):
        c = cycles[i] / args.steps
        print(f"  {label:30s} {c:9.0f}  {100 * c / total:5.1f}%")
    print(f"  {'total':30s} {total:9.0f}  = {total / float(clock):.2f} us "
          f"at {clock} MHz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
