"""Checkpoints of a run: save, crash-atomic swap, discovery, restore.

The counterpart of ``fumi_tpu/train/checkpoint.py`` with the same run-dir
layout: ``ckpt/`` (the latest state, every ``--eval_freq`` batches),
``best/`` (a copy when validation improved), and their metadata
``ckpt.meta.json`` / ``best.meta.json`` (``batch_idx``, ``best_loss``,
``model``, ``args``). The payload is the port's own: ``params.pt`` (the
params state dict) and ``opt_state.pt`` (the optimizer state: nested dicts
of tensors and the update count), written by ``torch.save`` from CPU
copies and read with ``torch.load(weights_only=True)``.

A reference ``.pth.tar`` file (the original FuMI code's checkpoint, or
one ``cli/export_torch.py`` wrote) is taken wherever a run dir is:
:func:`load_checkpoint` routes a file to ``interop.load_torch_checkpoint``.

Several processes (the JAX package's per-host policy): every process of
a ``--tpu_dist_*`` world saves its own complete checkpoint, this same
payload, into its own run dir (suffixed ``-p<rank>``,
``core/distributed.py``), with no coordination between them; the ranks a
single process spawned save once, from rank 0. The 2-D engine's
mp-sharded leaves are gathered at the end of each chunk
(``core/mesh.py:host_fetch``, ``parallel/pjit_engine.py``), so every
copy is whole and loads into a single-device server; after a killed rank,
``--tpu_auto_resume`` resumes every process from the newest of these
copies.

Not ported: wandb run paths for ``--checkpoint`` and uploads to a live
wandb run (they need the network; ROADMAP.md Queue 1, item 4b), and the
JAX package's orbax dirs and its multi-host ``np_tree.npz`` checkpoints
(both are JAX pytree formats; the tests carry such weights through
``bridge.py``, and a JAX run reaches the port as an exported
``.pth.tar``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, Optional, Tuple

import torch

_PAYLOAD = ("params.pt", "opt_state.pt")


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(run_dir: str, params, opt_state, batch_idx: int,
                    best_loss: float, is_best: bool,
                    extra_meta: Optional[dict] = None) -> None:
    """Save ``ckpt/``, and copy it to ``best/`` when ``is_best``.

    Crash-atomic as the JAX package's: the new state is written to a
    ``.new`` staging dir and swapped in by renames
    (:func:`_atomic_swap_in`), each meta file is replaced last by an atomic
    rename, so a kill at any point leaves a complete (dir, meta) pair,
    possibly one save old, or no dir at all."""
    run_dir = os.path.abspath(run_dir)
    os.makedirs(run_dir, exist_ok=True)
    ckpt_dir = os.path.join(run_dir, "ckpt")
    trees = (_to_cpu(params), _to_cpu(opt_state))

    def write(staging):
        os.makedirs(staging)
        for name, tree in zip(_PAYLOAD, trees):
            torch.save(tree, os.path.join(staging, name))
    _atomic_swap_in(ckpt_dir, write)
    meta = {"batch_idx": int(batch_idx), "best_loss": float(best_loss)}
    if extra_meta:
        meta.update(extra_meta)
    meta_tmp = os.path.join(run_dir, "ckpt.meta.json.new")
    with open(meta_tmp, "w") as f:
        json.dump(meta, f)
    os.replace(meta_tmp, os.path.join(run_dir, "ckpt.meta.json"))

    if is_best:
        _atomic_swap_in(os.path.join(run_dir, "best"),
                        lambda staging: shutil.copytree(ckpt_dir, staging))
        best_meta_tmp = os.path.join(run_dir, "best.meta.json.new")
        shutil.copyfile(os.path.join(run_dir, "ckpt.meta.json"),
                        best_meta_tmp)
        os.replace(best_meta_tmp, os.path.join(run_dir, "best.meta.json"))


def _atomic_swap_in(final_dir: str, write_to: Callable[[str], Any]) -> None:
    """Populate ``final_dir`` crash-atomically: ``write_to(staging)``
    builds the content in ``<final>.new``, the old dir is renamed aside to
    ``<final>.old``, the staging dir renamed in, and the old content
    deleted last. A ``.old`` left without ``final_dir`` by a crash between
    the two renames is the last good state: it is renamed back first.
    Other ``.new``/``.old`` leftovers are cleared."""
    staging, old = final_dir + ".new", final_dir + ".old"
    if os.path.exists(old) and not os.path.exists(final_dir):
        os.rename(old, final_dir)
    for leftover in (staging, old):
        if os.path.exists(leftover):
            shutil.rmtree(leftover)
    write_to(staging)
    if os.path.exists(final_dir):
        os.rename(final_dir, old)
    os.rename(staging, final_dir)
    if os.path.exists(old):
        shutil.rmtree(old)


def find_latest_resumable(log_dir: str, model: Optional[str] = None,
                          sweep_seeds: Optional[list] = None
                          ) -> Optional[str]:
    """Newest run dir under ``log_dir/runs`` holding a ``ckpt/``, ranked
    by the mtime of its ``ckpt.meta.json`` (the last save). ``model``
    keeps runs of that family; ``sweep_seeds`` keeps sweep checkpoints of
    exactly that seed list, and None drops every sweep checkpoint."""
    runs_dir = os.path.join(log_dir, "runs")
    if not os.path.isdir(runs_dir):
        return None
    best_path, best_t = None, -1.0
    for name in os.listdir(runs_dir):
        run = os.path.join(runs_dir, name)
        meta = os.path.join(run, "ckpt.meta.json")
        if os.path.exists(meta) and os.path.isdir(os.path.join(run, "ckpt")):
            try:
                with open(meta) as f:
                    md = json.load(f)
            except (OSError, ValueError):
                continue  # unreadable metadata: not resumable
            if model is not None and md.get("model") not in (None, model):
                continue
            if sweep_seeds is None:
                if md.get("sweep_seeds"):
                    continue
            elif list(md.get("sweep_seeds") or []) != list(sweep_seeds):
                continue
            t = os.path.getmtime(meta)
            if t > best_t:
                best_t, best_path = t, run
    return best_path


def resolve_checkpoint(checkpoint: str, model: str,
                       entity: str = "multimodal-image-cls",
                       project: Optional[str] = None) -> str:
    """``--checkpoint`` as a local path: an existing run dir, or a
    reference ``.pth.tar`` file (which :func:`load_checkpoint` imports),
    passes through. A wandb run path raises: resolving it needs the
    network."""
    if os.path.isdir(checkpoint) or os.path.isfile(checkpoint):
        return checkpoint
    raise NotImplementedError(
        f"--checkpoint {checkpoint!r} is not a local run dir or file; "
        f"resolving wandb run paths ({entity}/{project or model}/<run_id>) "
        "needs the network and is not ported to the PyTorch package "
        "(ROADMAP.md Queue 1, item 4b: not queued)")


def _flat(tree, prefix="") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _restore_like(saved, like, where: str):
    """``saved`` checked against the structure and shapes of ``like``, its
    tensors moved to the devices of ``like``'s."""
    got, want = _flat(saved), _flat(like)
    if set(got) != set(want):
        raise ValueError(
            f"{where}: saved entries {sorted(set(got) - set(want))[:5]} and "
            f"missing entries {sorted(set(want) - set(got))[:5]} against "
            "the restore template")
    for k, ref in want.items():
        if torch.is_tensor(ref) and (not torch.is_tensor(got[k])
                                     or got[k].shape != ref.shape):
            raise ValueError(f"{where}: entry {k!r} saved with shape "
                             f"{tuple(getattr(got[k], 'shape', ()))}, "
                             f"template {tuple(ref.shape)}")

    def place(s, ref):
        if isinstance(ref, dict):
            return {k: place(s[k], ref[k]) for k in ref}
        if torch.is_tensor(ref):
            return s.to(device=ref.device, dtype=ref.dtype)
        return s
    return place(saved, like)


def load_checkpoint(run_dir: str, params_like, opt_state_like,
                    best: bool = True) -> Tuple[Any, Any, Dict]:
    """Restore ``(params, opt_state, meta)`` from ``best/`` (or ``ckpt/``)
    of a run dir; ``params_like`` / ``opt_state_like`` give the structure,
    shapes and devices. A run with no ``best/`` falls back to ``ckpt/``.
    A mismatch raises ``ValueError`` with the flags the checkpoint was
    written with (``--tpu_ema``, ``--optim`` and ``--tpu_skip_nonfinite``
    change the optimizer state's structure). ``run_dir`` may also be a
    reference ``.pth.tar`` file: ``interop.load_torch_checkpoint`` maps it
    onto the templates (a file that does not load is a ``ValueError``)."""
    run_dir = os.path.abspath(run_dir)
    if os.path.isfile(run_dir):
        from fumi_tpu_torch import interop
        return interop.load_torch_checkpoint(run_dir, params_like,
                                             opt_state_like)
    name = "best" if best else "ckpt"
    if best and not os.path.isdir(os.path.join(run_dir, "best")) and \
            os.path.isdir(os.path.join(run_dir, "ckpt")):
        print(f"no best/ under {run_dir}; loading ckpt/ instead")
        name = "ckpt"
    path = os.path.join(run_dir, name)
    meta_path = os.path.join(run_dir, f"{name}.meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    try:
        params, opt_state = (
            _restore_like(torch.load(os.path.join(path, file),
                                     map_location="cpu", weights_only=True),
                          like, f"{path}/{file}")
            for file, like in zip(_PAYLOAD, (params_like, opt_state_like)))
    except (OSError, ValueError, RuntimeError, KeyError) as e:
        # a structure mismatch is usually a config mismatch between the
        # saving and the restoring run; the same error also covers
        # incomplete files, so the hint is phrased conditionally
        saved_args = meta.get("args") or {}
        hints = [f"{flag}={saved_args[flag]!r}"
                 for flag in ("ema", "optim", "skip_nonfinite", "model")
                 if flag in saved_args]
        hint = (f" The checkpoint was written with {', '.join(hints)} — "
                "if your current config differs (e.g. --tpu_ema/--optim), "
                "restore with a matching one; otherwise the checkpoint "
                "files themselves may be incomplete or corrupt."
                if hints else "")
        raise ValueError(
            f"cannot restore {path}: {type(e).__name__}: {e}.{hint}"
        ) from e
    print(f"Loaded {path}, trained to batch {meta.get('batch_idx')} "
          f"with best loss {meta.get('best_loss')}")
    return params, opt_state, meta
