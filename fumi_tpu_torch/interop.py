"""Reference checkpoints: import and export of ``.pth.tar`` files.

The counterpart of ``fumi_tpu/interop.py``. The original FuMI code saves
``{batch_idx, state_dict, best_loss, optimizer, args}`` with ``torch.save``;
this module maps that file to and from the port's params and optimizer
state, so a reference user brings a trained model (and keeps training it)
without retraining, and a run of the JAX package reaches a machine without
JAX as an exported file.

- **state_dict and params.** The port's params already are state dicts
  under the reference's names (``bridge.py``), so they map by name:
  ``net.lin_{i}`` and ``net.lin_final`` (MAML), ``text_encoder.*``,
  ``im_net.linear{i}``, ``hyper_net.0`` / ``hyper_net.2`` (FuMI),
  ``image_encoder``, ``text_encoder.*``, ``g.0`` / ``g.3``, ``h.0`` /
  ``h.3`` (AM3), ``text_fc``, ``text_fc2``, ``image_fc``, ``image_fc2``
  (CLIP). The raw-image backbones and the prototype families have no
  reference format.
- **Optimizer state.** torch Adam/AdamW ``exp_avg`` / ``exp_avg_sq`` /
  ``step`` land in the port's Adam ``mu`` / ``nu`` / ``count``, SGD's
  ``momentum_buffer`` in its ``trace``; a param torch built no state for
  (a frozen text encoder) keeps zero moments, as torch would on resume.
  After an import an EMA (``--tpu_ema``) points at the imported params.
- **Export** writes a file the reference's ``load_checkpoint`` restores,
  with an ``optimizer`` entry that torch's ``Optimizer.load_state_dict``
  accepts (one param group in registration order, the hyperparameter keys
  of the optimizer class the reference builds).

``train/checkpoint.py:load_checkpoint`` routes a file here, so the driver's
``--checkpoint``, serving's ``from_checkpoint`` / ``reload`` and
``POST /v1/reload`` take reference files; ``cli/export_torch.py`` exports.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

FAMILIES = ("maml", "am3", "fumi", "clip")
CLIP_LAYERS = ("text_fc", "text_fc2", "image_fc", "image_fc2")
_RNN = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")


def _lin(prefix: str) -> List[str]:
    return [prefix + ".weight", prefix + ".bias"]


def _count(keys, fmt: str) -> int:
    n = 0
    while fmt.format(n) in keys:
        n += 1
    return n


def _text_names(keys) -> List[str]:
    """The text encoder's names in torch registration order: none
    (BERT / precomputed), the ``rand`` encoder's Linear, or the word
    embedding and, for RNN/RNNhid, the biLSTM's forward then reverse
    weights."""
    keys = {k for k in keys if k.startswith("text_encoder.")}
    if not keys:
        return []
    if "text_encoder.weight" in keys:
        return _lin("text_encoder")
    names = ["text_encoder.embed.weight"]
    if any(".rnn." in k for k in keys):
        for sfx in ("", "_reverse"):
            names += [f"text_encoder.rnn.{n}{sfx}" for n in _RNN]
    return names


def reference_names(family: str, keys) -> List[str]:
    """The reference state_dict names of a ``family`` model whose names
    include ``keys``, in torch registration order (= state_dict order =
    ``model.parameters()`` order, which numbers the optimizer's params):
    AM3 registers image_encoder, text_encoder, g, h; FuMI text_encoder,
    im_net, then hyper_net (built first, assigned last)."""
    keys = set(keys)
    if family == "maml":
        n = _count(keys, "net.lin_{}.weight")
        return [x for i in range(n) for x in _lin(f"net.lin_{i}")] + \
            _lin("net.lin_final")
    if family == "am3":
        return (_lin("image_encoder") + _text_names(keys) + _lin("g.0")
                + _lin("g.3") + _lin("h.0") + _lin("h.3"))
    if family == "fumi":
        n = _count(keys, "im_net.linear{}.weight")
        return (_text_names(keys)
                + [x for i in range(n) for x in _lin(f"im_net.linear{i}")]
                + _lin("hyper_net.0") + _lin("hyper_net.2"))
    if family == "clip":
        return [x for k in CLIP_LAYERS for x in _lin(k)]
    raise ValueError(f"no torch interop for model family {family!r} "
                     f"(supported: {FAMILIES})")


def detect_family(state_dict: Mapping) -> str:
    """The model family of a reference state_dict, from its key names."""
    keys = set(state_dict)
    if any(k.startswith("net.lin_") for k in keys):
        return "maml"
    if any(k.startswith("hyper_net.") for k in keys):
        return "fumi"
    if any(k.startswith("g.") for k in keys):
        return "am3"
    if "text_fc.weight" in keys:
        return "clip"
    raise ValueError(
        "cannot infer a model family from this torch checkpoint "
        f"(keys: {sorted(keys)[:8]}...) — it does not look like a "
        "reference fumi checkpoint")


def _f32(x) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.detach().to("cpu", torch.float32)


def torch_to_params(state_dict: Mapping, family: str
                    ) -> "OrderedDict[str, torch.Tensor]":
    """A reference state_dict -> the port's params (fp32 CPU tensors, in
    registration order)."""
    names = reference_names(family, state_dict)
    missing = [n for n in names if n not in state_dict]
    if missing:
        raise ValueError(
            f"torch checkpoint is missing key {missing[0]!r} expected for a "
            f"{family!r} model — wrong --model for this checkpoint?")
    return OrderedDict((n, _f32(state_dict[n])) for n in names)


def params_to_torch(params: Mapping[str, torch.Tensor], family: str
                    ) -> "OrderedDict[str, torch.Tensor]":
    """The port's params -> a reference-named state_dict of fp32 CPU
    tensors in registration order, so torch's ``load_state_dict(strict=
    True)`` and the optimizer's param ids both line up."""
    names = reference_names(family, params)
    if set(names) != set(params):
        raise ValueError(
            f"params do not have the reference {family!r} structure "
            f"(extra {sorted(set(params) - set(names))[:4]}, missing "
            f"{sorted(set(names) - set(params))[:4]}) — extensions "
            "(raw-image encoders, registered families) have no reference "
            "checkpoint format")
    return OrderedDict((n, _f32(params[n]).clone()) for n in names)


# ---------------------------------------------------------------------------
# Optimizer state
# ---------------------------------------------------------------------------

def _torch_opt_moments(torch_opt: Optional[Mapping], key_order: List[str]):
    """Name-keyed Adam moments and SGD momentum buffers of a torch
    optimizer state dict, and the largest Adam step. torch numbers params
    in ``model.parameters()`` order, which is the checkpoint's state_dict
    order (the reference models hold no buffers)."""
    mom1: Dict[str, torch.Tensor] = {}
    mom2: Dict[str, torch.Tensor] = {}
    trace: Dict[str, torch.Tensor] = {}
    steps: List[int] = []
    if not torch_opt:
        return mom1, mom2, trace, 0
    for pid, st in (torch_opt.get("state") or {}).items():
        pid = int(pid)
        if pid >= len(key_order):
            continue
        name = key_order[pid]
        if "exp_avg" in st:
            mom1[name] = _f32(st["exp_avg"])
            mom2[name] = _f32(st["exp_avg_sq"])
            if st.get("step") is not None:
                steps.append(int(st["step"]))
        if st.get("momentum_buffer") is not None:
            trace[name] = _f32(st["momentum_buffer"])
    return mom1, mom2, trace, max(steps, default=0)


def _fill(table: Mapping[str, torch.Tensor], like: Mapping[str, Any]):
    return {k: table[k].to(v.device) if k in table else torch.zeros_like(v)
            for k, v in like.items()}


def _count_like(like, count: int):
    if torch.is_tensor(like):
        return torch.tensor(count, dtype=like.dtype, device=like.device)
    return int(count)


def inject_torch_opt_state(opt_state, torch_opt: Optional[Mapping],
                           state_dict: Mapping):
    """Place torch Adam/SGD state into the port's optimizer state: every
    Adam state (``{"count", "mu", "nu"}``) takes ``exp_avg`` /
    ``exp_avg_sq`` / ``step``, every SGD state (``{"trace"}``) the
    ``momentum_buffer``; params without torch state keep zero moments.
    Unchanged where the file carries no optimizer state."""
    mom1, mom2, trace, count = _torch_opt_moments(torch_opt,
                                                  list(state_dict))
    if not mom1 and not trace:
        return opt_state

    def walk(s):
        if not isinstance(s, dict):
            return s
        if set(s) == {"count", "mu", "nu"} and mom1:
            return {"count": _count_like(s["count"], count),
                    "mu": _fill(mom1, s["mu"]), "nu": _fill(mom2, s["nu"])}
        if set(s) == {"trace"} and trace:
            return {"trace": _fill(trace, s["trace"])}
        return {k: walk(v) for k, v in s.items()}
    return walk(opt_state)


def _reset_ema(opt_state, params):
    """Point any EMA state (``{"ema": ...}``) at the imported params: the
    template was made from the params before the import, and eval and
    serving read the EMA under ``--tpu_ema``."""
    if not isinstance(opt_state, dict):
        return opt_state
    if set(opt_state) == {"ema"}:
        return {"ema": dict(params)}
    return {k: _reset_ema(v, params) for k, v in opt_state.items()}


def _adam_or_trace(opt_state, params: Mapping) -> Dict[str, Any]:
    """The params-shaped Adam moments (and count) or SGD trace inside the
    port's optimizer state."""
    found = {"mu": None, "nu": None, "count": 0, "trace": None}

    def walk(s):
        if not isinstance(s, dict):
            return
        if set(s) == {"count", "mu", "nu"} and set(s["mu"]) == set(params):
            found.update(mu=s["mu"], nu=s["nu"], count=int(s["count"]))
        elif set(s) == {"trace"} and set(s["trace"]) == set(params):
            found["trace"] = s["trace"]
        else:
            for v in s.values():
                walk(v)
    walk(opt_state)
    return found


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def _mismatch(params, params_like) -> Optional[str]:
    if set(params) != set(params_like):
        return (f"structure mismatch: checkpoint entries "
                f"{sorted(set(params) - set(params_like))[:4]} and model "
                f"entries {sorted(set(params_like) - set(params))[:4]} have "
                "no counterpart")
    for k, v in params_like.items():
        if tuple(params[k].shape) != tuple(v.shape):
            return (f"shape mismatch: checkpoint {tuple(params[k].shape)} "
                    f"vs model {tuple(v.shape)} at {k}")
    return None


def load_torch_checkpoint(path: str, params_like=None, opt_state_like=None,
                          family: Optional[str] = None
                          ) -> Tuple[Dict[str, torch.Tensor], Any, Dict]:
    """A reference ``.pth.tar`` -> ``(params, opt_state, meta)``.

    Takes the full checkpoint dict or a bare state_dict. With
    ``params_like`` the params are checked against it (names and shapes;
    a mismatch is a ``ValueError`` that names the widths the file was
    trained with) and placed on its devices in its order; with
    ``opt_state_like`` the torch moments are injected into it and any EMA
    reset to the imported params. A file that does not load is a
    ``ValueError`` (serving answers it 400).

    The file is unpickled with ``torch.load(weights_only=False)``: a
    reference checkpoint carries its ``args``, which the restricted loader
    refuses. That is this import only, for files the user hands over; the
    port's own run dirs are read with ``weights_only=True``."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except Exception as e:
        raise ValueError(
            f"{path} is not a loadable torch checkpoint: "
            f"{type(e).__name__}: {e}") from e
    if isinstance(ckpt, Mapping) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
        meta = {"batch_idx": ckpt.get("batch_idx"),
                "best_loss": ckpt.get("best_loss"), "args": ckpt.get("args")}
        torch_opt = ckpt.get("optimizer")
    elif isinstance(ckpt, Mapping):
        sd, meta, torch_opt = ckpt, {}, None
    else:
        raise ValueError(f"{path} is not a loadable torch checkpoint: it "
                         f"holds a {type(ckpt).__name__}, not a dict")
    saved_args = meta.get("args") or {}
    family = family or saved_args.get("model") or detect_family(sd)

    params = torch_to_params(sd, family)
    if params_like is not None:
        err = _mismatch(params, params_like)
        if err:
            hints = {k: saved_args[k] for k in
                     ("model", "im_hid_dim", "prototype_dim", "text_encoder",
                      "text_emb_dim", "text_hid_dim", "im_emb_dim")
                     if k in saved_args}
            raise ValueError(
                f"torch checkpoint {path} does not fit the current model "
                f"config: {err}."
                + (f" The checkpoint was trained with {hints}." if hints
                   else ""))
        params = {k: params[k].to(device=v.device, dtype=v.dtype)
                  for k, v in params_like.items()}
    opt_state = opt_state_like
    if opt_state is not None:
        opt_state = _reset_ema(
            inject_torch_opt_state(opt_state, torch_opt, sd), params)
    print(f"Imported torch checkpoint {path} ({family}), trained to batch "
          f"{meta.get('batch_idx')} with best loss {meta.get('best_loss')}")
    return params, opt_state, meta


def export_torch_checkpoint(path: str, params, family: str, opt_state=None,
                            args: Optional[dict] = None, batch_idx: int = 0,
                            best_loss: float = float("inf"),
                            lr: float = 1e-3, weight_decay: float = 5e-4,
                            momentum: float = 0.9,
                            optim: str = "adam") -> None:
    """Write a reference-shaped ``.pth.tar`` that the reference restores.

    The ``optimizer`` entry is synthesized for torch's
    ``Optimizer.load_state_dict``, which replaces each param group with the
    saved one: one group over every param with the keys of the class the
    reference builds (``torch.optim.Adam``, ``torch.optim.SGD``, or
    transformers' AdamW with ``correct_bias`` beside torch AdamW's keys),
    and per-param Adam moments or SGD buffers from ``opt_state``."""
    sd = params_to_torch(params, family)
    order = list(sd)
    group: Dict[str, Any] = {"params": list(range(len(order))), "lr": lr,
                             "weight_decay": weight_decay}
    if optim == "SGD":
        group.update(momentum=momentum, dampening=0, nesterov=False,
                     maximize=False, foreach=None, differentiable=False)
    elif optim in ("adamw", "adamw_lin_schedule"):
        group.update(betas=(0.9, 0.999), eps=1e-6, correct_bias=True,
                     weight_decay=0.0, amsgrad=False, maximize=False,
                     foreach=None, capturable=False, differentiable=False,
                     fused=None)
    else:
        group.update(betas=(0.9, 0.999), eps=1e-8, amsgrad=False,
                     maximize=False, foreach=None, capturable=False,
                     differentiable=False, fused=None)
    found = _adam_or_trace(opt_state, params)
    state: Dict[int, Dict[str, Any]] = {}
    if found["mu"] is not None:
        for i, n in enumerate(order):
            state[i] = {"step": torch.tensor(float(found["count"])),
                        "exp_avg": _f32(found["mu"][n]).clone(),
                        "exp_avg_sq": _f32(found["nu"][n]).clone()}
    elif found["trace"] is not None:
        for i, n in enumerate(order):
            state[i] = {"momentum_buffer": _f32(found["trace"][n]).clone()}
    torch.save({"batch_idx": int(batch_idx), "state_dict": sd,
                "best_loss": float(best_loss),
                "optimizer": {"state": state, "param_groups": [group]},
                "args": dict(args or {})}, path)
