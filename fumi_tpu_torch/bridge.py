"""Carry weights and episodes between the JAX package and the port.

The JAX package keeps params as pytrees (tuples of ``{"w", "b"}`` layer
dicts); the port keeps flat state dicts keyed by the reference's
``state_dict`` names, the naming ``fumi_tpu/interop.py`` maps reference
checkpoints with:

- maml: ``net.lin_{i}`` for the hidden layers, ``net.lin_final`` the head;
- fumi: ``text_encoder`` (the ``rand`` encoder's unused Linear; nothing for
  BERT/precomputed), ``im_net.linear{i}``, ``hyper_net.0`` and
  ``hyper_net.2``.

Linear weights are (out, in) on both sides, so the conversion renames and
never transposes. Episodes keep their field names and dtypes. The bridge
takes and returns numpy leaves (callers turn JAX arrays into numpy with
``np.asarray``); it imports no JAX. Optimizer state is not carried.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from fumi_tpu_torch.core.episode import Episode
from fumi_tpu_torch.core.runtime import DeviceLike, resolve_device
from fumi_tpu_torch.models import mlp
from fumi_tpu_torch.models.fumi import im_net_depth

FAMILIES = ("maml", "fumi")


def _lin(prefix: str) -> Dict[str, str]:
    return {"w": prefix + ".weight", "b": prefix + ".bias"}


def _name_tree(family: str, n_layers: int, has_text_linear: bool):
    """Tree with the JAX package's structure whose leaves are names."""
    if family == "maml":
        return tuple([_lin(f"net.lin_{i}") for i in range(n_layers - 1)]
                     + [_lin("net.lin_final")])
    if family == "fumi":
        return {"text_encoder": _lin("text_encoder") if has_text_linear
                else {},
                "hyper_net": (_lin("hyper_net.0"), _lin("hyper_net.2")),
                "im_net": tuple(_lin(f"im_net.linear{i}")
                                for i in range(n_layers))}
    raise NotImplementedError(
        f"no bridge for model family {family!r} yet (have {FAMILIES})")


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


def params_from_jax(tree: Any, family: str,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """JAX param pytree (numpy leaves) -> the port's state dict on
    ``device`` (default: the current CUDA device)."""
    dev = resolve_device(device)
    if family == "maml":
        names = _name_tree("maml", len(tree), False)
    elif family == "fumi":
        te = tree["text_encoder"]
        if te and set(te) != {"w", "b"}:
            raise NotImplementedError(
                "token text encoders are not ported yet (ROADMAP.md "
                "Queue 1, item 5)")
        names = _name_tree("fumi", len(tree["im_net"]), bool(te))
    else:
        names = _name_tree(family, 0, False)
    return {name: torch.tensor(np.asarray(leaf, dtype=np.float32)).to(dev)
            for name, leaf in _pairs(names, tree)}


def params_to_numpy(params: Dict[str, torch.Tensor], family: str) -> Any:
    """The port's state dict -> the JAX package's pytree, numpy leaves."""
    if family == "maml":
        names = _name_tree("maml", len(mlp.layer_names(params)), False)
    elif family == "fumi":
        names = _name_tree("fumi", im_net_depth(params),
                           "text_encoder.weight" in params)
    else:
        names = _name_tree(family, 0, False)
    return _fill(names, lambda n: params[n].detach().cpu().numpy())


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
