#!/usr/bin/env python3
"""The episode gather's launch shape, measured on the card.

    python3 scripts/gather_variants.py [--variants 4x4,2x4,...] [--parent DIR]

Writes copies of ``fumi_tpu_torch/csrc/gather_rows.cu`` with other values of
``kUnroll`` (16-byte groups a lane loads before it stores), ``kWarps``
(most warps a block, all on one row) and ``kMixedUnroll`` (``kUnroll`` of
a launch that jitters its support rows and copies its query rows) into
the git-ignored
``fumi_tpu_torch/build/variants/``,
builds them there with ``nvcc`` (all at once; the kernel source has no
switch for this), and times each through the port's own wrappers on the
flagship table (4096 x 2048 fp32, seed 0), in CUDA graphs of 100 calls on
100 index sets (as 100 episodes draw them), 2 turns in each direction:

- ``gather_rows`` at the support gather (M=100) and the train query gather
  (M=640);
- ``gather_augment_rows`` at M=100;
- ``gather_episode_rows`` at the train (5+32 a class) and eval (5+20)
  episodes, B=4 tasks of 5 ways, without and with the jitter;

beside their bytes bounds, ``torch.index_select`` (one call over the same
rows; two for an episode), the Hopper bulk-copy form of the same gather
(``scripts/gather_bulk_copy.cu``: a TMA copy a row through shared memory,
1, 2, 4 or 8 rows a block) at the shapes without the jitter, and, with
``--parent DIR`` (an unpacked checkout
of an earlier commit), that commit's ``gather_rows.cu`` and
``augment_embeddings.cu`` built and called the same way: its gather at
M=100 and 640, its fused support pass, and its two-launch episode. Prints
the card and one line per candidate and shape, and writes the table to
``chiprun_out/gather_variants.json``. Needs one CUDA card and ``nvcc``;
imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (the timing helpers, run with no side effects)

B, WAYS, SHOTS = 4, 5, 5
TRAIN_Q, EVAL_Q = 32, 20
ROWS, D = 4096, 2048
AUG_SCALE = 0.1


def build(sources: dict, out_dir: str) -> dict:
    """{name: .cu path} -> {name: CDLL or the nvcc error}, one nvcc each,
    all at once."""
    from fumi_tpu_torch.ops import _build
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, src in sources.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
               "-o", lib, src]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln]
        libs[name] = (ctypes.CDLL(lib) if proc.returncode == 0
                      else f"nvcc failed:\n{out}")
        print(f"build {name}: {'ok' if proc.returncode == 0 else 'FAILED'}"
              + "".join(f"\n  ptxas {r}" for r in regs[:2]), flush=True)
    return libs


def variant_source(src: str, unroll: int, warps: int,
                   mixed_unroll: int) -> str:
    for name, value in (("kUnroll", unroll), ("kWarps", warps),
                        ("kMixedUnroll", mixed_unroll)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"gather_rows.cu has no single {name}")
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="2x4m4,2x4m2,2x8m4,4x4m4,1x4m4",
                    help="kUnroll x kWarps m kMixedUnroll, comma-separated")
    ap.add_argument("--parent", default=None,
                    help="an unpacked checkout whose gather kernels to time")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail("gather_variants needs a CUDA card")
    from fumi_tpu_torch.ops import _build, kernels
    print(f"card: {chip_smoke.card_line()}", flush=True)
    dev = torch.device("cuda", 0)

    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    with open(os.path.join(_build.CSRC, "gather_rows.cu")) as f:
        src = f.read()
    sources = {}
    for spec in args.variants.split(","):
        u, w, m = (int(x) for x in re.fullmatch(r"(\d+)x(\d+)m(\d+)",
                                                spec).groups())
        path = os.path.join(out_dir, f"gather_rows_u{u}w{w}m{m}.cu")
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(variant_source(src, u, w, m))
        sources[f"u{u}w{w}m{m}"] = path
    sources["bulk"] = os.path.join(HERE, "scripts", "gather_bulk_copy.cu")
    if args.parent:
        csrc = os.path.join(args.parent, "fumi_tpu_torch", "csrc")
        sources["parent_gather"] = os.path.join(csrc, "gather_rows.cu")
        sources["parent_augment"] = os.path.join(csrc,
                                                 "augment_embeddings.cu")
    libs = build(sources, out_dir)

    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((ROWS, D), generator=gen, device=dev)
    m_s = B * WAYS * SHOTS

    def idx_sets(shape):
        return [torch.randint(0, ROWS, shape, generator=gen,
                              dtype=torch.int32, device=dev)
                for _ in range(100)]
    seeds = [torch.randint(0, 2 ** 62, (1,), generator=gen,
                           dtype=torch.int64, device=dev) for _ in range(100)]
    shapes = {"gather M=100": idx_sets((m_s,)),
              "gather M=640": idx_sets((B * WAYS * TRAIN_Q,)),
              "jittered M=100": idx_sets((m_s,)),
              "train episode": idx_sets((B, WAYS, SHOTS + TRAIN_Q)),
              "eval episode": idx_sets((B, WAYS, SHOTS + EVAL_Q)),
              "train episode, jittered": idx_sets((B, WAYS,
                                                   SHOTS + TRAIN_Q))}
    row = D * 4

    def nbytes(shape):
        """Rows and indices read, rows written; the seed's 8 bytes."""
        return (chip_smoke.gather_bytes(shapes[shape][0].numel(), row)
                + (8 if "jitter" in shape else 0))

    def wrapper_calls(shape):
        """The port's wrappers on this shape's 100 index sets."""
        sets = shapes[shape]
        if shape.startswith("gather"):
            return [lambda i=i: kernels.gather_rows(table, i) for i in sets]
        if shape == "jittered M=100":
            return [lambda i=i, s=s: kernels.gather_augment_rows(
                table, i, s, AUG_SCALE) for i, s in zip(sets, seeds)]
        if "jittered" in shape:
            return [lambda i=i, s=s: kernels.gather_episode_rows(
                table, i, SHOTS, s, AUG_SCALE) for i, s in zip(sets, seeds)]
        return [lambda i=i: kernels.gather_episode_rows(table, i, SHOTS)
                for i in sets]

    def library_calls(shape, split):
        """index_select over the same rows: one call, or, with ``split``,
        one per segment of an episode."""
        sets = shapes[shape]
        if "episode" not in shape:
            return [lambda i=i.long(): torch.index_select(table, 0, i)
                    for i in sets]
        if not split:
            return [lambda i=i.reshape(-1).long():
                    torch.index_select(table, 0, i) for i in sets]
        return [lambda s=i[..., :SHOTS].reshape(-1).long(),
                q=i[..., SHOTS:].reshape(-1).long():
                (torch.index_select(table, 0, s),
                 torch.index_select(table, 0, q)) for i in sets]

    def parent_calls(shape):
        """The earlier commit's kernels: its gather, its fused support
        pass, and an episode as its sampler launched it (support, then
        queries)."""
        g, a = libs.get("parent_gather"), libs.get("parent_augment")
        if isinstance(g, str) or isinstance(a, str) or g is None:
            return None
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        g.gather_rows_launch.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
        a.gather_augment_launch.argtypes = [ptr, i32, ptr, ptr, ptr, i64,
                                            i64, i32, i64, ctypes.c_float,
                                            ptr]

        def gather(idx):
            out = torch.empty((idx.numel(), D), device=dev)
            g.gather_rows_launch(table.data_ptr(), idx.data_ptr(),
                                 out.data_ptr(), ROWS, idx.numel(), row,
                                 torch.cuda.current_stream().cuda_stream)
            return out

        def augment(idx, seed):
            out = torch.empty((idx.numel(), D), device=dev)
            a.gather_augment_launch(table.data_ptr(), 0, idx.data_ptr(),
                                    seed.data_ptr(), out.data_ptr(), ROWS,
                                    idx.numel(), D, 0, 2 * AUG_SCALE,
                                    torch.cuda.current_stream().cuda_stream)
            return out
        sets = shapes[shape]
        if shape.startswith("gather"):
            return [lambda i=i: gather(i) for i in sets]
        if shape == "jittered M=100":
            return [lambda i=i, s=s: augment(i, s)
                    for i, s in zip(sets, seeds)]
        split = [(i[..., :SHOTS].reshape(-1).contiguous(),
                  i[..., SHOTS:].reshape(-1).contiguous()) for i in sets]
        if "jittered" in shape:
            return [lambda p=p, s=s: (augment(p[0], s), gather(p[1]))
                    for p, s in zip(split, seeds)]
        return [lambda p=p: (gather(p[0]), gather(p[1])) for p in split]

    def bulk_calls(shape, per_block):
        """The bulk-copy form at the shapes it covers (fp32, no jitter)."""
        lib = libs.get("bulk")
        if "jitter" in shape or isinstance(lib, str) or lib is None:
            return None
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bulk_episode_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i64,
                                            i32, i32, i32, i32, ptr]

        def run(rows, k):
            classes, p = (rows.numel(), 1) if rows.dim() == 1 else (
                rows.shape[0] * rows.shape[1], rows.shape[2])
            s = torch.empty((classes * k, D), device=dev)
            q = torch.empty((classes * (p - k), D), device=dev)
            err = lib.bulk_episode_launch(
                table.data_ptr(), rows.data_ptr(), s.data_ptr(),
                q.data_ptr() if q.numel() else None, ROWS, classes, k, p - k,
                row, per_block, torch.cuda.current_stream().cuda_stream)
            if err:
                chip_smoke.fail(f"bulk copy launch failed: CUDA error {err}")
            return s, q
        k = 1 if shape.startswith("gather") else SHOTS
        return [lambda i=i: run(i, k) for i in shapes[shape]]

    candidates = {}
    for name, lib in libs.items():
        if name.startswith("parent") or name == "bulk" or isinstance(lib,
                                                                     str):
            continue
        bound = kernels.bind_gather(lib)
        candidates[name] = lambda shape, b=bound: (b, wrapper_calls(shape))
    results = {}
    real = kernels._gather_library
    for shape in shapes:
        calls = {}
        for name, make in candidates.items():
            lib, fns = make(shape)
            calls[name] = (lib, fns)
        calls["index_select"] = (None, library_calls(shape, False))
        if "episode" in shape:
            calls["two index_selects"] = (None, library_calls(shape, True))
        for per_block in (1, 2, 4, 8):
            bulk = bulk_calls(shape, per_block)
            if bulk is not None:
                calls[f"bulk r{per_block}"] = (None, bulk)
        parent = parent_calls(shape) if args.parent else None
        if parent is not None:
            calls["parent"] = (None, parent)
        order = list(calls) + list(reversed(calls))
        order += order
        turns = {}
        for name in order:
            lib, fns = calls[name]
            if lib is not None:
                kernels._gather_library = lambda lib=lib: lib
            try:
                turns.setdefault(name, []).append(
                    1e3 * chip_smoke.graph_ms(fns))
            finally:
                kernels._gather_library = real
        bound_us = 1e6 * nbytes(shape) / chip_smoke.PEAK_BYTES_PER_S
        results[shape] = {"bound_us": bound_us,
                          "us": {n: statistics.median(t)
                                 for n, t in turns.items()},
                          "turns": turns}
        for name, t in turns.items():
            print(f"{shape}: {name} {statistics.median(t):.3f} us (turns "
                  f"{', '.join(f'{x:.3f}' for x in t)}), bound "
                  f"{bound_us:.3f} us (bytes)", flush=True)
    # the bitwise check of each variant against the plain version, at the
    # jittered train episode (the widest epilogue)
    i, s = shapes["train episode, jittered"][0], seeds[0]
    want = kernels.gather_episode_rows_reference(table, i, SHOTS, s,
                                                 AUG_SCALE)
    for name, make in candidates.items():
        lib, _ = make("train episode")
        kernels._gather_library = lambda lib=lib: lib
        try:
            got = kernels.gather_episode_rows(table, i, SHOTS, s, AUG_SCALE)
            torch.cuda.synchronize()
        finally:
            kernels._gather_library = real
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"{name}: bitwise equal to the plain version {same}")
        if not same:
            chip_smoke.fail(f"variant {name} differs from the plain version")
    for shape in ("train episode", "gather M=100"):
        i = shapes[shape][0]
        want = (kernels.gather_episode_rows_reference(table, i, SHOTS)
                if i.dim() == 3 else
                (kernels.gather_rows_reference(table, i),))
        for per_block in (1, 8):
            got = bulk_calls(shape, per_block)[0]()
            torch.cuda.synchronize()
            same = all(torch.equal(g.reshape(w.shape), w)
                       for g, w in zip(got, want))
            print(f"bulk r{per_block} at the {shape}: bitwise equal to the "
                  f"plain version {same}")
            if not same:
                chip_smoke.fail("the bulk copy differs from the plain version")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "gather_variants.json"),
              "w") as f:
        json.dump({"card": chip_smoke.card_line(), "results": results}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
