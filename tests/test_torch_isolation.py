"""The port stands alone: no JAX and nothing of ``fumi_tpu`` at run time,
a config copy that agrees with the original, and entry points that run on
the card unless asked for the CPU."""

import dataclasses
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import fumi_tpu.core.config as jax_config
import fumi_tpu_torch
from fumi_tpu_torch import bridge
from fumi_tpu_torch.core import config as port_config
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.core.runtime import resolve_device
from fumi_tpu_torch.data import synthetic
from fumi_tpu_torch.data.sampler import DeviceEpisodeSampler
from fumi_tpu_torch.serve import FewShotClassifier
from fumi_tpu_torch.train import steps

PKG_DIR = os.path.dirname(fumi_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="fumi_tpu_torch."))


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'fumi_tpu' or m.startswith('fumi_tpu.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(port_modules()) >= 10


def test_source_has_no_jax_or_fumi_tpu_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|fumi_tpu)(\.|\s|$)", re.M)
    hits = []
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, f)) as fh:
                    if pattern.search(fh.read()):
                        hits.append(f)
    assert not hits


def test_config_copy_defaults_equal_the_original():
    ours = {f.name: f.default for f in dataclasses.fields(port_config.Config)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jax_config.Config)}
    assert ours  # the copy keeps every field
    assert set(ours) == set(theirs)
    for name, default in ours.items():
        assert default == theirs[name], name
    for const in ("TEXT_ENCODERS", "TOKEN_TEXT_ENCODERS", "TEXT_TYPES",
                  "MODELS", "OPTIMIZERS"):
        assert getattr(port_config, const) == getattr(jax_config, const)


@pytest.mark.parametrize("kw", [
    dict(), dict(dataset="synthetic", im_emb_dim=64),
    dict(im_emb_dim=512), dict(image_embedding_model="resnet-34"),
    dict(image_embedding_model="resnet-34", im_emb_dim=512),
    dict(text_encoder="nope"), dict(im_encoder="nope"),
    dict(text_type=("bad",)), dict(optim="nope"),
    dict(compute_dtype="float16"), dict(grad_accum=3),
    dict(meta_grad="reptile", model="fumi"),
    dict(meta_grad="imaml", model="fumi"),
    dict(adapt_params="head", model="fumi"), dict(ema=1.0),
    dict(seed_sweep=2, model="clip"), dict(seed_accum=2),
    dict(remat="sometimes"), dict(model="nope"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_config_validate_agrees(kw):
    """validate() accepts and rejects the same configs, with the same
    exception types."""
    def outcome(mod):
        try:
            mod.Config(**kw).validate()
            return None
        except Exception as e:  # the exception type is what is compared
            return type(e)
    assert outcome(port_config) == outcome(jax_config)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without device='cpu' the entry points ask for CUDA and raise where
    it is missing; they never carry on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.Config(model="maml", dataset="synthetic",
                             im_emb_dim=16, im_hid_dim=(8, 8), num_ways=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        FewShotClassifier(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.params_from_jax(({"w": np.zeros((3, 4)),
                                 "b": np.zeros(3)},), "maml")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"
    assert FewShotClassifier(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def _sampler(**kw):
    cs, table, ids = synthetic.synthetic_class_set(
        num_classes=4, images_per_class=6, im_dim=8, text_dim=4)
    return DeviceEpisodeSampler(table, ids, cs, EpisodeSpec(1, 2, 1, 1, 8, 4),
                                **kw)


def _steps(**kw):
    cfg = port_config.Config(model="fumi", dataset="synthetic", im_emb_dim=8,
                             text_emb_dim=4, im_hid_dim=(4, 4),
                             text_hid_dim=4, num_ways=2,
                             text_encoder="precomputed")
    return steps.make_steps(cfg, torch.Generator().manual_seed(0), **kw)


def _episode(**kw):
    return bridge.episode_from_numpy(
        bridge.episode_to_numpy(EpisodeSpec(1, 2, 1, 1, 8, 4).zeros("cpu")),
        **kw)


@pytest.mark.parametrize("entry", [_sampler, _steps, _episode],
                         ids=["DeviceEpisodeSampler", "make_steps",
                              "episode_from_numpy"])
def test_training_entry_points_default_to_cuda(monkeypatch, entry):
    """The sampler, the steps and the episode bridge ask for CUDA unless
    given device='cpu', and then hold every tensor on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    out = entry(device="cpu")
    tensors = (list(out.tables) if isinstance(out, DeviceEpisodeSampler)
               else list(out.params.values()) if hasattr(out, "params")
               else [t for t in out if t is not None])
    assert tensors and all(t.device.type == "cpu" for t in tensors)
