"""Carry weights and episodes between the JAX package and the port.

The JAX package keeps params as pytrees (tuples of ``{"w", "b"}`` layer
dicts); the port keeps flat state dicts keyed by the reference's
``state_dict`` names, the naming ``fumi_tpu/interop.py`` maps reference
checkpoints with:

- maml: ``net.lin_{i}`` for the hidden layers, ``net.lin_final`` the head;
- fumi: ``text_encoder`` (the ``rand`` encoder's unused Linear; nothing for
  BERT/precomputed; ``text_encoder.embed.weight`` for glove/w2v, and
  with it ``text_encoder.rnn.{weight,bias}_{ih,hh}_l0[_reverse]`` for
  RNN/RNNhid, from the JAX package's ``embed``, ``w_ih``, ``w_hh``,
  ``b_ih``, ``b_hh`` and their ``_rev`` twins), ``im_net.linear{i}``,
  ``hyper_net.0`` and ``hyper_net.2``;
- am3: ``image_encoder``, ``text_encoder`` (as for fumi), ``g.0``/``g.3``
  and ``h.0``/``h.3``;
- protonet, matchingnet (no reference counterpart): their one bare
  ``{"w", "b"}`` linear is ``image_encoder``;
- clip: ``text_fc``, ``text_fc2``, ``image_fc`` and ``image_fc2``.

The raw-image backbones (``--im_encoder conv4|resnet12``) keep the JAX
package's nesting in their names: conv4's ``convs[i]`` is
``convs.{i}.{weight,bias,gamma,beta}`` (the JAX ``w``, ``b``, ``gamma``,
``beta``), resnet12's ``blocks[i][u]`` is ``blocks.{i}.{u}.…`` for u in
c1, c2, c3, sc, and a ``head`` is ``head.{weight,bias}``. MAML's whole net
and ProtoNet's and MatchingNet's backbone with its projection ``head``
sit at the top level; FuMI's headless backbone under ``im_net.``, AM3's
backbone and ``head`` under ``image_encoder.``.

Linear and LSTM weights are (out, in) on both sides, so the conversion
renames them. Conv kernels are the one transpose: the JAX package's HWIO
becomes the port's OIHW (and back). ``gamma`` and ``beta`` carry over as
they are. Episodes keep their field names and dtypes.
The bridge takes and returns numpy leaves (callers turn JAX arrays into
numpy with ``np.asarray``); it imports no JAX. Optimizer state is not
carried.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from fumi_tpu_torch.core.episode import Episode
from fumi_tpu_torch.core.runtime import DeviceLike, resolve_device
from fumi_tpu_torch.models import conv4, mlp, resnet12, text_encoders
from fumi_tpu_torch.models.fumi import im_net_depth

FAMILIES = ("maml", "fumi", "am3", "protonet", "matchingnet", "clip")
CLIP_LAYERS = ("text_fc", "text_fc2", "image_fc", "image_fc2")


def _lin(prefix: str) -> Dict[str, str]:
    return {"w": prefix + ".weight", "b": prefix + ".bias"}


def _text_tree(kind: str) -> Dict[str, str]:
    """The ``text_encoder`` subtree's names: ``"none"`` (BERT /
    precomputed), ``"linear"`` (the ``rand`` encoder's Linear), ``"embed"``
    (glove / w2v) or ``"rnn"`` (RNN / RNNhid)."""
    if kind == "linear":
        return _lin("text_encoder")
    names = {} if kind == "none" else {"embed": text_encoders.EMBED}
    if kind == "rnn":
        for sfx, rev in (("", ""), ("_rev", "_reverse")):
            for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                 ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                names[ours + sfx] = f"text_encoder.rnn.{theirs}_l0{rev}"
    return names


def _unit(prefix: str) -> Dict[str, str]:
    return {"w": prefix + ".weight", "b": prefix + ".bias",
            "gamma": prefix + ".gamma", "beta": prefix + ".beta"}


def _backbone_tree(prefix: str, kind: str, n: int, head: bool):
    """A raw backbone's names: ``kind`` "convs" (conv4) or "blocks"
    (resnet12) with ``n`` of them, and a ``head`` if asked."""
    if kind == "convs":
        tree = {"convs": tuple(_unit(f"{prefix}convs.{i}")
                               for i in range(n))}
    else:
        tree = {"blocks": tuple({u: _unit(f"{prefix}blocks.{i}.{u}")
                                 for u in resnet12.UNITS}
                                for i in range(n))}
    if head:
        tree["head"] = _lin(prefix + "head")
    return tree


def _raw_kind(tree, prefix: str = ""):
    """``(kind, n)`` of a raw backbone in a JAX subtree or under
    ``prefix`` of the port's names; None for the embedding layouts."""
    if isinstance(tree, dict):
        for kind in ("convs", "blocks"):
            if kind in tree:
                return kind, len(tree[kind])
    n = conv4.num_blocks(tree, prefix) if not isinstance(tree, tuple) \
        else 0
    if n:
        return "convs", n
    n = resnet12.num_blocks(tree, prefix) if not isinstance(tree, tuple) \
        else 0
    return ("blocks", n) if n else None


def _raw_name_tree(family: str, raw, text_kind: str):
    """The names of a family whose image encoder is a raw backbone."""
    kind, n = raw
    if family in ("maml", "protonet", "matchingnet"):
        return _backbone_tree("", kind, n, head=True)
    if family == "fumi":
        return {"text_encoder": _text_tree(text_kind),
                "hyper_net": (_lin("hyper_net.0"), _lin("hyper_net.2")),
                "im_net": _backbone_tree("im_net.", kind, n, head=False)}
    if family == "am3":
        return {"image_encoder": _backbone_tree("image_encoder.", kind, n,
                                                head=True),
                "text_encoder": _text_tree(text_kind),
                "g": (_lin("g.0"), _lin("g.3")),
                "h": (_lin("h.0"), _lin("h.3"))}
    raise NotImplementedError(
        f"no raw-image bridge for model family {family!r}")


def _name_tree(family: str, n_layers: int, text_kind: str):
    """Tree with the JAX package's structure whose leaves are names."""
    if family == "maml":
        return tuple([_lin(f"net.lin_{i}") for i in range(n_layers - 1)]
                     + [_lin("net.lin_final")])
    if family == "fumi":
        return {"text_encoder": _text_tree(text_kind),
                "hyper_net": (_lin("hyper_net.0"), _lin("hyper_net.2")),
                "im_net": tuple(_lin(f"im_net.linear{i}")
                                for i in range(n_layers))}
    if family == "am3":
        return {"image_encoder": _lin("image_encoder"),
                "text_encoder": _text_tree(text_kind),
                "g": (_lin("g.0"), _lin("g.3")),
                "h": (_lin("h.0"), _lin("h.3"))}
    if family in ("protonet", "matchingnet"):
        return _lin("image_encoder")
    if family == "clip":
        return {name: _lin(name) for name in CLIP_LAYERS}
    raise NotImplementedError(
        f"no bridge for model family {family!r} yet (have {FAMILIES})")


def _text_kind(keys) -> str:
    """The text encoder's kind from its JAX keys or the port's names."""
    keys = set(keys)
    if keys & {"w", "text_encoder.weight"}:
        return "linear"
    if keys & {"w_ih", "text_encoder.rnn.weight_ih_l0"}:
        return "rnn"
    return "embed" if keys & {"embed", text_encoders.EMBED} else "none"


def _pairs(names, tree):
    """(name, leaf) pairs of two trees of the same structure."""
    if isinstance(names, str):
        yield names, tree
    elif isinstance(names, dict):
        if set(names) != set(tree):
            raise ValueError(f"param tree keys {sorted(tree)} != expected "
                             f"{sorted(names)}")
        for k in names:
            yield from _pairs(names[k], tree[k])
    else:
        if len(names) != len(tree):
            raise ValueError(f"param tree has {len(tree)} layers, expected "
                             f"{len(names)}")
        for n, t in zip(names, tree):
            yield from _pairs(n, t)


def _fill(names, leaf_of):
    if isinstance(names, str):
        return leaf_of(names)
    if isinstance(names, dict):
        return {k: _fill(v, leaf_of) for k, v in names.items()}
    return tuple(_fill(n, leaf_of) for n in names)


_ENCODER = {"fumi": "im_net", "am3": "image_encoder"}


def params_from_jax(tree: Any, family: str,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """JAX param pytree (numpy leaves) -> the port's state dict on
    ``device`` (default: the current CUDA device)."""
    dev = resolve_device(device)
    enc = tree.get(_ENCODER.get(family)) if isinstance(tree, dict) else None
    raw = _raw_kind(enc if family in _ENCODER else tree) \
        if family != "clip" else None
    text_kind = (_text_kind(tree["text_encoder"]) if family in _ENCODER
                 else "none")
    if raw is not None:
        names = _raw_name_tree(family, raw, text_kind)
    elif family == "maml":
        names = _name_tree("maml", len(tree), "none")
    elif family in _ENCODER:
        names = _name_tree(family, len(tree.get("im_net", ())), text_kind)
    else:
        names = _name_tree(family, 0, "none")

    def leaf(a):
        a = np.asarray(a, dtype=np.float32)
        # conv kernels: HWIO -> OIHW
        return np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a
    return {name: torch.tensor(np.ascontiguousarray(leaf(x))).to(dev)
            for name, x in _pairs(names, tree)}


def params_to_numpy(params: Dict[str, torch.Tensor], family: str) -> Any:
    """The port's state dict -> the JAX package's pytree, numpy leaves."""
    prefix = _ENCODER[family] + "." if family in _ENCODER else ""
    raw = _raw_kind(params, prefix) if family != "clip" else None
    if raw is not None:
        names = _raw_name_tree(family, raw, _text_kind(params))
    elif family == "maml":
        names = _name_tree("maml", len(mlp.layer_names(params)), "none")
    elif family in ("fumi", "am3"):
        names = _name_tree(family, im_net_depth(params), _text_kind(params))
    else:
        names = _name_tree(family, 0, "none")

    def leaf(n):
        a = params[n].detach().cpu().numpy()
        # conv kernels: OIHW -> HWIO
        return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0))) \
            if a.ndim == 4 else a
    return _fill(names, leaf)


def episode_from_numpy(episode: Any, device: DeviceLike = None) -> Episode:
    """An episode with numpy leaves (the JAX package's ``Episode`` after
    ``np.asarray`` on each leaf, or any object with its field names) ->
    the port's :class:`Episode` on ``device`` (default: the current CUDA
    device). Dtypes are kept; None stays None."""
    dev = resolve_device(device)

    def put(name):
        leaf = getattr(episode, name)
        if leaf is None:
            return None
        return torch.from_numpy(np.array(leaf)).to(dev)
    return Episode(*(put(name) for name in Episode._fields))


def episode_to_numpy(episode: Episode) -> Episode:
    """The port's episode with numpy leaves on the host."""
    return Episode(*(None if t is None else t.detach().cpu().numpy()
                     for t in episode))
