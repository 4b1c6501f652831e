"""Export a trained run of the port as a reference-format torch checkpoint.

Usage::

    python -m fumi_tpu_torch.cli.export_torch <run_dir> <out.pth.tar> [--ckpt]

``<run_dir>`` is a run directory the port's driver wrote (``config.json``
with ``best/`` and ``ckpt/``). The output is the reference's checkpoint
``{batch_idx, state_dict, best_loss, optimizer, args}``, which the
original FuMI code's ``load_checkpoint`` restores, with the Adam moments
(or SGD buffers) as per-param ``exp_avg`` / ``exp_avg_sq`` / ``step``
entries; ``--checkpoint`` and serving read it back (``interop.py``).
``--ckpt`` exports the latest checkpoint instead of the best. The
counterpart of ``fumi_tpu/cli/export_torch.py``; it runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("run_dir", help="run directory (with config.json)")
    p.add_argument("out", help="output .pth.tar path")
    p.add_argument("--ckpt", action="store_true",
                   help="export ckpt/ (latest) instead of best/")
    args = p.parse_args(argv)

    from fumi_tpu_torch import interop
    from fumi_tpu_torch.core.config import config_from_json
    from fumi_tpu_torch.train import checkpoint as ckpt_lib
    from fumi_tpu_torch.train.loop import eval_view
    from fumi_tpu_torch.train.steps import build_family, make_opt

    cfg_path = os.path.join(args.run_dir, "config.json")
    if not os.path.exists(cfg_path):
        raise SystemExit(f"{args.run_dir} has no config.json — not a run "
                         "directory written by the port's driver")
    cfg = config_from_json(cfg_path)
    if cfg.model not in interop.FAMILIES:
        raise SystemExit(
            f"--model {cfg.model} has no reference checkpoint format "
            f"(exportable: {interop.FAMILIES})")
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.model == "clip":
        from fumi_tpu_torch.train import clip_loop
        _, params_like = clip_loop.make_clip(cfg, gen)
    else:
        from fumi_tpu_torch.serve import serving_dictionary
        params_like = build_family(
            cfg, gen, serving_dictionary(cfg, args.run_dir)).params
    params, opt_state, meta = ckpt_lib.load_checkpoint(
        args.run_dir, params_like, make_opt(cfg).init(params_like),
        best=not args.ckpt)
    # under --tpu_ema validation selected, and serving serves, the EMA:
    # export it, so the file's eval reproduces its best_loss (the moments
    # still describe the raw trajectory)
    batch_idx, best_loss = meta.get("batch_idx"), meta.get("best_loss")
    interop.export_torch_checkpoint(
        args.out, eval_view(cfg, params, opt_state), cfg.model,
        opt_state=opt_state, args=dataclasses.asdict(cfg),
        batch_idx=int(batch_idx) if batch_idx is not None else 0,
        best_loss=(float(best_loss) if best_loss is not None
                   else float("inf")),
        lr=cfg.lr, weight_decay=cfg.weight_decay, momentum=cfg.momentum,
        optim=cfg.optim)
    print(f"exported {cfg.model} run {args.run_dir} -> {args.out}")
    return args.out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
