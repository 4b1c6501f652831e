"""Model families, as far as serving reads them.

The counterpart of the model-and-params part of
``fumi_tpu/train/steps.py``'s ``build_maml_family`` / ``build_fumi_family``
and of ``plain_full_gd_adaptation``. The episode losses, optimizers and
train/eval steps are ROADMAP.md Queue 1, item 3.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.models import fumi as fumi_mod
from fumi_tpu_torch.models import mlp, text_encoders

RAW_IMAGE_ENCODERS = ("conv4", "resnet12")


class Family(NamedTuple):
    """A model family: its freshly initialised params and its model spec
    (None for MAML, whose forward is ``mlp.apply``)."""
    name: str
    params: Dict[str, torch.Tensor]
    model: Any = None


def plain_full_gd_adaptation(cfg: Config) -> bool:
    """True when TEST-TIME adaptation is the plain full-parameter GD
    program the fused kernel implements. iMAML's proximal objective and
    ANIL's head-only updates are different programs; Reptile's eval-time
    adaptation IS plain GD (only its meta-update differs)."""
    return (cfg.meta_grad in ("explicit", "reptile")
            and cfg.adapt_params == "all")


def _no_raw_images(cfg: Config) -> None:
    if cfg.im_encoder in RAW_IMAGE_ENCODERS:
        raise NotImplementedError(
            f"--im_encoder {cfg.im_encoder} is not ported yet (ROADMAP.md "
            "Queue 1, item 7: raw-image backbones)")


def build_maml_family(cfg: Config, gen: torch.Generator) -> Family:
    """PureImageNetwork over precomputed embeddings."""
    _no_raw_images(cfg)
    params = mlp.init(gen, cfg.im_emb_dim, cfg.num_ways, cfg.im_hid_dim)
    return Family(name="maml", params=params)


def build_fumi_family(cfg: Config, gen: torch.Generator) -> Family:
    """FuMI hypernet + headless image MLP."""
    _no_raw_images(cfg)
    enc = text_encoders.make_text_encoder(cfg.text_encoder, gen,
                                          cfg.text_emb_dim, cfg.fine_tune)
    model = fumi_mod.FUMI(
        n_way=cfg.num_ways, im_emb_dim=cfg.im_emb_dim,
        im_hid_dim=tuple(cfg.im_hid_dim), text_encoder=enc,
        text_emb_dim=enc.out_dim, text_hid_dim=cfg.text_hid_dim,
        dropout_rate=cfg.dropout, norm_hypernet=cfg.norm_hypernet,
        fine_tune=cfg.fine_tune, init_bias=cfg.hypernet_bias_init,
        init_all_layers=cfg.init_all_layers)
    return Family(name="fumi", params=model.init_params(gen), model=model)


def build_family(cfg: Config, gen: torch.Generator) -> Family:
    if cfg.model == "maml":
        return build_maml_family(cfg, gen)
    if cfg.model == "fumi":
        return build_fumi_family(cfg, gen)
    raise NotImplementedError(
        f"model {cfg.model!r} is not ported yet (ROADMAP.md Queue 1, "
        "item 5: the other families)")
