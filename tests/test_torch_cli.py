"""The port's experiment driver on the CPU (``--disable_cuda``), against
the JAX package's where both compute the same thing.

- ``build_parser`` has the JAX parser's flags, defaults, types and
  choices; ``config_from_args`` gives the JAX package's ``Config`` field
  for field; ``config_from_json`` round-trips a run's ``config.json``.
- ``main`` trains and tests FuMI and MAML at tiny widths with
  ``--augment`` and the kernel flags: a finite ``TEST`` dict with its 95%
  intervals, ``ckpt/`` and ``best/``, and a prediction CSV whose bytes
  equal what the JAX package's ``_save_predictions_csv`` (pandas) writes
  from the same test metrics. ``--evaluate --checkpoint`` reproduces
  FuMI's test metrics exactly; ``--tpu_auto_resume`` continues the batch
  counter of the newest run of the same family.
- What the driver does not run yet raises ``NotImplementedError`` naming
  its ROADMAP.md item, and what it has run since the training extensions
  and the host samplers were ported runs; without CUDA and without
  ``--disable_cuda`` it raises.
"""

import dataclasses
import glob
import json
import os
import time
import types

import numpy as np
import pytest
import torch

import fumi_tpu.cli.main as jax_cli
import fumi_tpu.core.config as jax_config
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core import config
from fumi_tpu_torch.train import checkpoint

# tiny widths; 20 eval queries per class at 5 ways (num_query_eval)
TINY = ["--dataset", "synthetic", "--im_emb_dim", "32", "--text_emb_dim",
        "16", "--im_hid_dim", "16", "8", "--text_hid_dim", "8",
        "--num_ways", "3", "--num_shots", "2", "--num_shots_test", "4",
        "--num_train_adapt_steps", "2", "--num_test_adapt_steps", "10",
        "--batch_size", "2", "--num_ep_test", "6", "--lr", "0.01",
        "--step_size", "0.1", "--dropout", "0", "--text_encoder",
        "precomputed", "--seed", "0", "--wandb_offline", "--disable_cuda"]
KERNELS = ["--augment", "--tpu_pallas_gather", "--tpu_pallas_fused_eval"]


def argv(log_dir, model, *extra, epochs=8, eval_freq=4):
    return TINY + KERNELS + ["--model", model, "--log_dir", str(log_dir),
                             "--epochs", str(epochs), "--eval_freq",
                             str(eval_freq), *extra]


def cfg_of(*args, **kw):
    return config.config_from_args(argv(*args, **kw))


# ---------------------------------------------------------------------------
# parser and config
# ---------------------------------------------------------------------------

def _actions(parser):
    return {a.option_strings[0]: (a.default, a.type, a.choices, a.nargs,
                                  type(a).__name__)
            for a in parser._actions if a.option_strings
            and a.option_strings[0] != "-h"}


def test_parser_has_the_jax_parsers_flags_and_defaults():
    ours, theirs = (_actions(config.build_parser()),
                    _actions(jax_config.build_parser()))
    assert set(ours) == set(theirs)
    for flag in theirs:
        assert ours[flag] == theirs[flag], flag


@pytest.mark.parametrize("args", [
    [],
    ["--model", "maml", "--augment", "--tpu_pallas_gather", "--epochs", "7",
     "--im_hid_dim", "32", "16", "--text_type", "label", "description"],
    ["--model", "fumi", "--dataset", "synthetic", "--disable_cuda",
     "--tpu_auto_resume", "--tpu_chunk", "16", "--checkpoint", "x",
     "--lamda_fixed", "1", "--tpu_resnet12_channels", "8", "12"],
    ["--tpu_host_sampler", "--optim", "SGD", "--tpu_pallas_fused_eval",
     "--tpu_compute_dtype", "bfloat16", "--tpu_profile_dir", "p",
     "--seed", "-4", "--evaluate", "--wandb_offline"],
    ["--model", "protonet", "--tpu_meta_grad", "explicit", "--tpu_remat",
     "off", "--tpu_ema", "0.5", "--tpu_seed_sweep", "2",
     "--tpu_dist_process_id", "3"],
])
def test_config_from_args_equals_the_jax_packages(args):
    ours = config.config_from_args(args)
    theirs = jax_config.config_from_args(args)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_config_from_args_rejects_as_the_jax_package():
    for bad in (["--text_encoder", "nope"], ["--tpu_grad_accum", "3"],
                ["--model", "nope"]):
        with pytest.raises((SystemExit, ValueError, NotImplementedError,
                            NameError)) as ours:
            config.config_from_args(bad)
        with pytest.raises(ours.type):
            jax_config.config_from_args(bad)


def test_config_from_json_round_trips(tmp_path):
    cfg = cfg_of(tmp_path, "fumi").replace(im_hid_dim=(5, 4, 3),
                                           text_type=("label",))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(dataclasses.asdict(cfg), default=str))
    assert config.config_from_json(str(path)) == cfg
    assert dataclasses.asdict(jax_config.config_from_json(str(path))) == \
        dataclasses.asdict(cfg)


# ---------------------------------------------------------------------------
# the driver end to end
# ---------------------------------------------------------------------------

@pytest.fixture
def captured(monkeypatch):
    """The test metrics each run hands to its CSV writer."""
    seen = []
    orig = cli_main._save_predictions_csv

    def spy(cfg, writer, results_path, test_m):
        seen.append((cfg, writer, results_path, test_m))
        return orig(cfg, writer, results_path, test_m)
    monkeypatch.setattr(cli_main, "_save_predictions_csv", spy)
    return seen


def _run_dirs(log_dir):
    return sorted(glob.glob(os.path.join(str(log_dir), "runs", "*")))


@pytest.mark.parametrize("model", ["fumi", "maml"])
def test_main_trains_tests_and_writes_the_jax_packages_csv(
        tmp_path, model, captured):
    if model == "fumi":  # the command-line entry point
        out = cli_main.cli(argv(tmp_path, model))
    else:
        out = cli_main.main(cfg_of(tmp_path, model))
    for k in ("loss", "acc", "acc_ci95", "loss_ci95"):
        assert np.isfinite(out[f"test/{k}"]), k
    assert 0.0 <= out["test/acc"] <= 1.0
    (run,) = _run_dirs(tmp_path)
    for name in ("ckpt", "best", "ckpt.meta.json", "best.meta.json",
                 "config.json"):
        assert os.path.exists(os.path.join(run, name)), name
    with open(os.path.join(run, "ckpt.meta.json")) as f:
        meta = json.load(f)
    assert meta["batch_idx"] == 8 and meta["model"] == model
    assert config.config_from_json(os.path.join(run, "config.json")) == \
        cfg_of(tmp_path, model)

    # the CSV: the bytes the JAX package's pandas writer gives
    (cfg, writer, results, test_m), = captured
    (ours,) = glob.glob(os.path.join(str(tmp_path), "results", "run_*.csv"))
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    theirs = jax_cli._save_predictions_csv(
        jax_config.Config(**dataclasses.asdict(cfg)),
        types.SimpleNamespace(run_name=writer.run_name), str(jax_dir),
        test_m)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    rows = (cfg.max_test_batches + 1) * cfg.batch_size
    with open(ours) as f:
        lines = f.read().splitlines()
    assert lines[0] == ",support_idx,query_idx,query_preds,query_targets"
    assert len(lines) == 1 + rows


def test_csv_with_a_lamda_column_is_the_jax_packages(tmp_path):
    """The writer's other column set (AM3's support_lamda floats) gives
    the same bytes as pandas, too."""
    cfg = cfg_of(tmp_path, "fumi")
    rng = np.random.RandomState(0)
    nk, nq, tasks = 6, cfg.num_ways * cfg.num_query_eval, 3
    test_m = {"preds": rng.randint(0, 3, tasks * nq).tolist(),
              "targets": rng.randint(0, 3, tasks * nq).tolist(),
              "query_idx": rng.randint(0, 999, tasks * nq).tolist(),
              "support_idx": rng.randint(0, 999, tasks * nk).tolist(),
              "support_lamdas": rng.rand(tasks * nk).astype(
                  np.float32).tolist()}
    w = types.SimpleNamespace(run_name="abc")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours = cli_main._save_predictions_csv(cfg, w, str(tmp_path / "a"), test_m)
    theirs = jax_cli._save_predictions_csv(cfg, w, str(tmp_path / "b"),
                                           test_m)
    assert os.path.basename(ours) == "run_abc.csv"
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_evaluate_from_checkpoint_reproduces_fumis_test(tmp_path):
    out = cli_main.main(cfg_of(tmp_path / "train", "fumi"))
    (run,) = _run_dirs(tmp_path / "train")
    again = cli_main.main(cfg_of(tmp_path / "eval", "fumi").replace(
        evaluate=True, checkpoint=run))
    assert again == out
    assert not _run_dirs(tmp_path / "eval")[0].endswith("ckpt")
    assert not os.path.exists(os.path.join(_run_dirs(tmp_path / "eval")[0],
                                           "ckpt"))


def test_auto_resume_continues_the_counter_of_its_own_family(tmp_path):
    """A MAML run stopped at batch 4, then a FuMI run in the same log_dir:
    resuming MAML picks the MAML run (not the newer FuMI one), loads its
    ckpt/ and finishes the budget from batch 5 on."""
    cli_main.main(cfg_of(tmp_path, "maml", epochs=4, eval_freq=2))
    (maml_run,) = _run_dirs(tmp_path)
    os.utime(os.path.join(maml_run, "ckpt.meta.json"), (1, 1))  # older
    time.sleep(1.1)  # runs are named by the second they start in
    cli_main.main(cfg_of(tmp_path, "fumi", epochs=2, eval_freq=2))
    assert checkpoint.find_latest_resumable(str(tmp_path), "maml") == maml_run
    assert checkpoint.find_latest_resumable(str(tmp_path)) != maml_run

    time.sleep(1.1)
    out = cli_main.main(cfg_of(tmp_path, "maml", "--tpu_auto_resume",
                               epochs=8, eval_freq=2))
    assert np.isfinite(out["test/loss"])
    new = [r for r in _run_dirs(tmp_path) if r != maml_run
           and json.load(open(os.path.join(r, "ckpt.meta.json")))["model"]
           == "maml"]
    assert len(new) == 1
    steps = [json.loads(line).get("_step") for line in open(glob.glob(
        os.path.join(str(tmp_path), "results",
                     os.path.basename(new[0]) + ".metrics.jsonl"))[0])
        if "train/loss" in line]
    assert steps == list(range(5, 9))  # batches 5..8: the counter went on
    with open(os.path.join(new[0], "ckpt.meta.json")) as f:
        assert json.load(f)["batch_idx"] == 8


@pytest.mark.parametrize("extra,item", [
    # the seed sweep, --tpu_profile_dir and --tpu_watch run since they were
    # ported (tests/test_torch_sweep.py, tests/test_torch_watch.py); their
    # cases now hold the multi-device part of item 9, still rejected
    (["--tpu_seed_sweep", "2", "--tpu_mesh_dp", "2"], "item 9"),
    (["--tpu_mesh_mp", "2"], "item 9"),
    (["--tpu_dist_num_processes", "2"], "item 9"),
    (["--tpu_import", "os", "--tpu_mesh_dp", "2"], "item 9"),
    # resolving a wandb run path needs the network
    (["--checkpoint", "someone/proj/run1"], "item 4"),
])
def test_what_is_not_ported_raises_naming_its_item(tmp_path, extra, item):
    with pytest.raises(NotImplementedError, match=item):
        cli_main.main(config.config_from_args(
            argv(tmp_path, "fumi") + extra))


RAW_SMALL = ["--tpu_im_size", "16"]


@pytest.mark.parametrize("extra", [
    # the cases the driver rejected until the training extensions (item
    # 10) and the host samplers (item 4b) were ported, raw images at 16x16
    ["--model", "am3", "--text_encoder", "glove", "--im_encoder", "conv4",
     "--tpu_skip_nonfinite", "2", *RAW_SMALL],
    ["--model", "maml", "--tpu_meta_grad", "reptile", "--im_encoder",
     "resnet12", "--tpu_ema", "0.5", *RAW_SMALL,
     "--tpu_resnet12_channels", "4", "6", "8", "8"],
    ["--model", "protonet", "--tpu_compute_dtype", "bfloat16",
     "--tpu_debug_nans"],
    ["--dataset", "cub", "--tpu_debug_nans"],
    ["--tpu_host_sampler"], ["--tpu_ema", "0.9"],
], ids=["am3-glove-conv4-skip", "maml-reptile-resnet12-ema",
        "protonet-bf16-debug-nans", "cub-debug-nans", "host-sampler",
        "fumi-ema"])
def test_the_training_extensions_and_host_samplers_run(tmp_path, capsys,
                                                       monkeypatch, extra):
    """Each runs to a finite ``TEST`` line now. ``--dataset cub`` reads
    the synthetic splits here (the CUB loader has its own tests)."""
    from fumi_tpu_torch.data.synthetic import synthetic_splits
    monkeypatch.setattr(cli_main, "load_cub", lambda data_dir: (
        synthetic_splits(num_classes=32, images_per_class=40, im_dim=32,
                         text_dim=16, seed=0)))
    out = cli_main.main(config.config_from_args(
        argv(tmp_path, "fumi", epochs=2, eval_freq=2) + extra))
    assert np.isfinite(out["test/loss"]) and 0 <= out["test/acc"] <= 1
    printed = capsys.readouterr().out
    assert ("host sampler backend: native" in printed) == \
        ("--tpu_host_sampler" in extra)


def test_without_cuda_the_driver_raises_unless_asked_for_the_cpu(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cfg_of(tmp_path, "maml").replace(disable_cuda=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main.main(cfg)
    assert config.Config().disable_cuda is False


# ---------------------------------------------------------------------------
# checkpoints (as tests/test_checkpoint_resolve.py holds the JAX package's)
# ---------------------------------------------------------------------------

def test_load_checkpoint_falls_back_to_ckpt(tmp_path):
    params = {"w": torch.ones(2, 2)}
    opt_state = {"count": 3, "mu": {"w": torch.zeros(2, 2)}}
    checkpoint.save_checkpoint(str(tmp_path), params, opt_state, 3, 9.9,
                               is_best=False)
    assert not (tmp_path / "best").exists()
    p, s, meta = checkpoint.load_checkpoint(str(tmp_path), params, opt_state,
                                            best=True)
    assert torch.equal(p["w"], params["w"]) and s["count"] == 3
    assert meta["batch_idx"] == 3
    with pytest.raises(ValueError, match="template"):
        checkpoint.load_checkpoint(str(tmp_path), {"v": torch.ones(2)},
                                   opt_state)


def test_atomic_swap_restores_aside_renamed_state(tmp_path):
    final = os.path.join(str(tmp_path), "ckpt")

    def write_marker(staging):
        os.makedirs(staging)
        with open(os.path.join(staging, "state.txt"), "w") as f:
            f.write("good")

    checkpoint._atomic_swap_in(final, write_marker)
    os.rename(final, final + ".old")  # the crash window between renames

    def failing_write(staging):
        raise RuntimeError("simulated crash during the next save")

    with pytest.raises(RuntimeError):
        checkpoint._atomic_swap_in(final, failing_write)
    with open(os.path.join(final, "state.txt")) as f:
        assert f.read() == "good"


def test_resolve_checkpoint_passes_a_local_dir_and_rejects_the_rest(
        tmp_path):
    """A local run dir and a local ``.pth.tar`` file pass through (the
    file is imported by ``load_checkpoint``); a wandb run path needs the
    network and raises."""
    assert checkpoint.resolve_checkpoint(str(tmp_path), "fumi") == \
        str(tmp_path)
    ref = tmp_path / "best.pth.tar"
    ref.write_bytes(b"x")
    assert checkpoint.resolve_checkpoint(str(ref), "fumi") == str(ref)
    with pytest.raises(NotImplementedError, match="item 4"):
        checkpoint.resolve_checkpoint("entity/project/run", "fumi")
