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


def test_every_module_imports_without_h5py_pil_or_transformers():
    """The card's machine has none of them: each port module imports with
    the three blocked (``sys.modules[name] = None`` makes an import of it
    raise), so they are imported only inside the functions that need
    them."""
    code = (
        "import importlib, sys\n"
        "for blocked in ('h5py', 'PIL', 'transformers'):\n"
        "    sys.modules[blocked] = None\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "import h5py\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    # every module imported; only the last line's own import failed
    assert out.returncode == 1, out.stderr
    assert out.stderr.strip().splitlines()[-1].startswith(
        "ModuleNotFoundError: import of h5py halted"), out.stderr


def test_the_data_and_meta_gradient_modules_are_among_those_checked():
    """The host data code, the offline prep CLI and the meta-gradient
    variants are walked by the import checks above."""
    assert {"fumi_tpu_torch.data.vocab", "fumi_tpu_torch.data.inat_anim",
            "fumi_tpu_torch.data.vectors", "fumi_tpu_torch.data.cub",
            "fumi_tpu_torch.data.verify", "fumi_tpu_torch.data.prepare",
            "fumi_tpu_torch.metalearn.reptile",
            "fumi_tpu_torch.metalearn.implicit"} <= set(port_modules())


def test_the_backbone_and_bf16_modules_are_among_those_checked():
    """The raw-image backbones, their dispatch and the bf16 primitives are
    walked by the import checks above (jax, fumi_tpu, h5py, PIL and
    transformers blocked)."""
    assert {"fumi_tpu_torch.models", "fumi_tpu_torch.models.conv4",
            "fumi_tpu_torch.models.resnet12", "fumi_tpu_torch.models.layers",
            "fumi_tpu_torch.data.sampler",
            "fumi_tpu_torch.data.synthetic"} <= set(port_modules())


def test_the_extension_and_interop_modules_are_among_those_checked():
    """The reference-checkpoint importer, its export CLI and the native
    sampler's loader are walked by the import checks above; the loader's
    source is the port's own copy, never the JAX package's library (which
    ``tests/test_torch_host_sampler.py`` checks in a fresh process)."""
    assert {"fumi_tpu_torch.interop", "fumi_tpu_torch.cli.export_torch",
            "fumi_tpu_torch.native"} <= set(port_modules())
    from fumi_tpu_torch import native
    assert native.SOURCE.startswith(PKG_DIR + os.sep)
    assert native.lib_path().startswith(os.path.join(PKG_DIR, "build"))


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


def test_the_driver_modules_are_among_those_checked():
    """The modules of the experiment driver are walked by the import
    checks above."""
    assert {"fumi_tpu_torch.cli.main", "fumi_tpu_torch.train.loop",
            "fumi_tpu_torch.train.checkpoint", "fumi_tpu_torch.train.logging",
            "fumi_tpu_torch.utils.profiling"} <= set(port_modules())


def test_the_driver_defaults_to_cuda(monkeypatch, tmp_path):
    """``python -m fumi_tpu_torch.cli.main`` asks for CUDA and raises
    where it is missing, unless ``--disable_cuda`` asks for the CPU."""
    from fumi_tpu_torch.cli import main as cli_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--model", "maml", "--dataset", "synthetic", "--im_emb_dim",
            "8", "--im_hid_dim", "4", "4", "--num_ways", "2",
            "--log_dir", str(tmp_path), "--wandb_offline"]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main.cli(args)
    assert port_config.config_from_args(args + ["--disable_cuda"]) \
        .disable_cuda


def test_the_serving_and_family_modules_are_among_those_checked():
    """The HTTP front-end, AM3 and the metrics are walked by the import
    checks above: no JAX and nothing of fumi_tpu at run time."""
    assert {"fumi_tpu_torch.serve_http", "fumi_tpu_torch.models.am3",
            "fumi_tpu_torch.ops.metrics"} <= set(port_modules())


def test_the_server_defaults_to_cuda(monkeypatch, tmp_path):
    """The HTTP server's classifier and ``from_checkpoint`` ask for CUDA
    and raise where it is missing, unless ``--disable_cuda`` or
    device='cpu' asks for the CPU."""
    from fumi_tpu_torch import serve_http
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.Config(model="protonet", dataset="synthetic",
                             im_emb_dim=16, prototype_dim=4, num_ways=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_http.build_classifier(cfg, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        FewShotClassifier.from_checkpoint(str(tmp_path), cfg)
    clf = serve_http.build_classifier(cfg.replace(disable_cuda=True), None)
    assert clf.device.type == "cpu"
    assert serve_http.FewShotService(clf).healthz()["backend"] == "cpu"


def test_the_clip_and_token_encoder_modules_are_among_those_checked():
    """CLIP, its loop, the supervised data copy and the token encoders are
    walked by the import checks above: no JAX and nothing of fumi_tpu at
    run time."""
    assert {"fumi_tpu_torch.models.clip", "fumi_tpu_torch.train.clip_loop",
            "fumi_tpu_torch.data.supervised",
            "fumi_tpu_torch.models.text_encoders"} <= set(port_modules())


@pytest.mark.parametrize("shuffle", [True, False])
def test_supervised_copy_equals_the_original(shuffle):
    """``data/supervised.py`` is a copy of the JAX package's numpy module:
    the same tables from a class set, the same padded batches from the
    same seed."""
    import fumi_tpu.data.supervised as jax_sup
    from fumi_tpu_torch.data import supervised
    cs, table, _ = synthetic.synthetic_class_set(
        num_classes=6, images_per_class=5, im_dim=8, text_dim=4, seed=2)
    cs.class_counts = np.array([5, 3, 5, 1, 4, 5], np.int32)  # ragged
    ours = supervised.supervised_from_class_set(cs)
    theirs = jax_sup.supervised_from_class_set(cs)
    assert ours.num_items == theirs.num_items == 23
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    got = list(supervised.epoch_batches(ours, table, 7,
                                        np.random.RandomState(1), shuffle))
    want = list(jax_sup.epoch_batches(theirs, table, 7,
                                      np.random.RandomState(1), shuffle))
    assert [g[3] for g in got] == [w[3] for w in want] == [7, 7, 7, 2]
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(a, b)


def test_the_clip_server_and_token_steps_default_to_cuda(monkeypatch):
    """``ClipRetrieval`` and token-encoder steps ask for CUDA and raise
    where it is missing, unless given device='cpu'."""
    from fumi_tpu_torch.data.synthetic import synthetic_dictionary
    from fumi_tpu_torch.serve import ClipRetrieval
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clip = port_config.Config(model="clip", dataset="synthetic",
                              im_emb_dim=8, text_emb_dim=4,
                              clip_latent_dim=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClipRetrieval(clip)
    assert ClipRetrieval(clip, device="cpu").device.type == "cpu"
    cfg = port_config.Config(model="fumi", dataset="synthetic", im_emb_dim=8,
                             text_emb_dim=4, im_hid_dim=(4, 4),
                             text_hid_dim=4, num_ways=2, text_encoder="RNN")
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.make_steps(cfg, torch.Generator().manual_seed(0),
                         dictionary=synthetic_dictionary(8))
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), "cpu",
                          dictionary=synthetic_dictionary(8))
    assert all(t.device.type == "cpu" for t in st.params.values())


def test_the_multi_device_modules_are_among_those_checked():
    """The process groups, the mesh, the launcher and both engines are
    walked by the import checks above: no JAX and nothing of fumi_tpu at
    run time."""
    assert {"fumi_tpu_torch.core.distributed", "fumi_tpu_torch.core.mesh",
            "fumi_tpu_torch.parallel", "fumi_tpu_torch.parallel.launch",
            "fumi_tpu_torch.parallel.engine",
            "fumi_tpu_torch.parallel.pjit_engine"} <= set(port_modules())


def test_a_rank_without_a_card_raises(monkeypatch):
    """A rank asked for a card where CUDA is missing raises before it
    joins any world; it never carries on quietly on the CPU."""
    from fumi_tpu_torch.core import distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.initialize(num_processes=1, process_id=0,
                               init_method="file:///nonexistent/store")
    assert not distributed.is_initialized()
