"""The port's driver on several CPU ranks (gloo), the counterpart of
``tests/test_distributed.py``: two ``--tpu_dist_*`` processes, the
single-process ``--tpu_mesh_dp``/``--tpu_mesh_mp`` form (the driver spawns
the ranks) for the cases it refused before the engines were ported, a
seed sweep over two ranks, a CLIP step over two ranks, and a killed rank
resumed by ``--tpu_auto_resume``.

Widths: image 32 (256 where mp shards it), im_hid (16, 8), text 16,
3-way 2-shot, B=4. Each process runs one intra-op thread
(``OMP_NUM_THREADS=1``), so runs that are compared bitwise run the same
kernels.
"""

import ast
import glob
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fumi_tpu_torch.core.config import Config, config_from_args
from fumi_tpu_torch.parallel.launch import spawn_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--dataset", "synthetic", "--im_hid_dim", "16", "8",
          "--text_emb_dim", "16", "--num_ways", "3", "--num_shots", "2",
          "--num_shots_test", "3", "--num_train_adapt_steps", "2",
          "--num_test_adapt_steps", "2", "--seed", "0", "--lr", "1e-2",
          "--dropout", "0.0", "--batch_size", "4", "--wandb_offline",
          "--disable_cuda"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(args):
    return subprocess.Popen(
        [sys.executable, "-m", "fumi_tpu_torch.cli.main"] + args,
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _finish(procs):
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
    return outs


def _dist(tmp_path, n, extra, port=None):
    port = port or _free_port()
    return [_launch(COMMON + ["--model", "maml", "--im_emb_dim", "32",
                              "--log_dir", str(tmp_path),
                              "--tpu_dist_coordinator", f"localhost:{port}",
                              "--tpu_dist_num_processes", str(n),
                              "--tpu_dist_process_id", str(i)] + extra)
            for i in range(n)]


def _test_line(out: str) -> dict:
    m = re.search(r"TEST: (\{.*\})", out)
    assert m, f"no TEST line in output:\n{out[-3000:]}"
    return ast.literal_eval(m.group(1))


def test_two_dist_processes_agree_and_keep_their_own_runs(tmp_path):
    """Two --tpu_dist_* processes on one dp=2 mesh: identical TEST lines,
    run dirs suffixed -p0 and -p1, each with its own checkpoint."""
    outs = _finish(_dist(tmp_path, 2, ["--epochs", "6", "--eval_freq", "3",
                                       "--num_ep_test", "8"]))
    for i, out in enumerate(outs):
        assert f"rank {i}/2, backend gloo" in out, out[-2000:]
        assert "mesh: dp=2 x mp=1" in out
    a, b = (_test_line(o) for o in outs)
    assert a == b and all(np.isfinite(v) for v in a.values())
    runs = sorted(os.listdir(tmp_path / "runs"))
    assert len(runs) == 2 and runs[0].endswith("-p0") \
        and runs[1].endswith("-p1"), runs
    for r in runs:
        assert (tmp_path / "runs" / r / "ckpt").is_dir(), r


def test_a_killed_rank_resumes_from_the_checkpoint(tmp_path):
    """One of two --tpu_dist_* processes is killed after the first
    checkpoint; the same command with --tpu_auto_resume continues from it
    on both ranks (the same batch) and ends with identical TEST lines."""
    procs = _dist(tmp_path, 2, ["--epochs", "600", "--eval_freq", "3",
                                "--num_ep_test", "8"])
    try:
        deadline = time.time() + 300
        while not glob.glob(str(tmp_path / "runs" / "*" / "ckpt.meta.json")):
            assert time.time() < deadline, "no checkpoint within 300 s"
            assert all(p.poll() is None for p in procs), \
                procs[0].communicate()[0][-3000:]
            time.sleep(0.2)
        time.sleep(0.5)
        procs[1].kill()
        procs[0].wait(timeout=120)  # its next collective fails
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    assert procs[0].returncode != 0
    outs = _finish(_dist(tmp_path, 2, ["--epochs", "12", "--eval_freq", "3",
                                       "--num_ep_test", "8",
                                       "--tpu_auto_resume"]))
    batches = set()
    for out in outs:
        m = re.search(r"auto-resume: .* \(batch (\d+)\)", out)
        assert m, out[-2000:]
        batches.add(int(m.group(1)))
    assert len(batches) == 1 and min(batches) >= 3
    assert _test_line(outs[0]) == _test_line(outs[1])


def test_spawned_2d_run_serves_on_one_device(tmp_path):
    """--tpu_mesh_dp 2 --tpu_mesh_mp 2 in one process: the driver spawns
    four CPU ranks; rank 0 alone writes the run dir, whose checkpoint holds
    whole weights that a single-device FewShotClassifier serves."""
    from fumi_tpu_torch.serve import FewShotClassifier
    from fumi_tpu_torch.train.steps import make_steps
    args = COMMON + ["--model", "fumi", "--im_emb_dim", "256",
                     "--epochs", "4", "--eval_freq", "2", "--num_ep_test",
                     "8", "--tpu_mesh_dp", "2", "--tpu_mesh_mp", "2",
                     "--log_dir", str(tmp_path)]
    out = _finish([_launch(args)])[0]
    assert "spawning 4 ranks for the (2, 2) mesh (cpu)" in out
    assert len(re.findall(r"TEST: ", out)) == 1
    assert np.isfinite(_test_line(out)["loss"])
    runs = os.listdir(tmp_path / "runs")
    assert len(runs) == 1
    run = str(tmp_path / "runs" / runs[0])
    cfg = config_from_args(args).validate()
    clf = FewShotClassifier.from_checkpoint(run, cfg, device="cpu")
    whole = make_steps(cfg, torch.Generator().manual_seed(0), "cpu").params
    assert {k: v.shape for k, v in clf.params.items()} == \
        {k: v.shape for k, v in whole.items()}
    rng = np.random.RandomState(0)
    s_y = np.repeat(np.arange(3), 2).astype(np.int32)
    logits = clf.episode_logits(
        rng.randn(6, 256).astype(np.float32), s_y,
        rng.randn(5, 256).astype(np.float32),
        rng.randn(6, 16).astype(np.float32))
    assert np.asarray(logits).shape == (5, 3)
    assert np.isfinite(np.asarray(logits)).all()


def test_dp_sweep_seeds_are_the_single_rank_sweeps(tmp_path):
    """--tpu_seed_sweep 4 --tpu_mesh_dp 2: two ranks of two seeds each;
    every seed's exported params are bitwise the single-rank sweep's."""
    sweep = COMMON + ["--model", "fumi", "--im_emb_dim", "32", "--epochs",
                      "4", "--eval_freq", "2", "--num_ep_test", "8",
                      "--tpu_seed_sweep", "4"]
    dp_out, one_out = _finish([
        _launch(sweep + ["--tpu_mesh_dp", "2",
                         "--log_dir", str(tmp_path / "dp")]),
        _launch(sweep + ["--log_dir", str(tmp_path / "one")])])
    assert "seed sweep sharded over dp=2 ranks (4 seeds, 2 a rank)" in dp_out
    for out in (dp_out, one_out):
        assert "SWEEP TEST" in out
    for k in range(4):
        a, b = (torch.load(glob.glob(str(tmp_path / d / "runs" / "*" /
                                         f"seed{k}" / "ckpt" /
                                         "params.pt"))[0])
                for d in ("dp", "one"))
        for n in a:
            assert torch.equal(a[n], b[n]), (k, n)
    assert len(glob.glob(str(tmp_path / "dp" / "results" / "*_seed*.csv"))) \
        == 4


def clip_rank(rank):
    """A CLIP step over two ranks' rows and the serial step, on the same
    deduped batch with one invalid row."""
    from fumi_tpu_torch.core.mesh import make_mesh
    from fumi_tpu_torch.train import clip_loop, optim
    cfg = Config(model="clip", dataset="synthetic", im_emb_dim=32,
                 text_emb_dim=16, clip_latent_dim=8, batch_size=8)
    model, params = clip_loop.make_clip(cfg, torch.Generator().manual_seed(0))
    opt = optim.init_optim("adam", 1e-3, 5e-4, 0.9)
    rng = np.random.RandomState(1)
    text = torch.from_numpy(rng.randn(8, 16).astype(np.float32))
    image = torch.from_numpy(rng.randn(8, 32).astype(np.float32))
    mesh = make_mesh(2, 1)
    dp = clip_loop.dp_train_step(model, opt, params, opt.init(params), text,
                                 image, 7, mesh)
    serial = clip_loop.train_step(model, opt, params, opt.init(params), text,
                                  image, 7)
    return {"dp": (dp[0], dp[2]), "serial": (serial[0], serial[2])}


def test_dp_clip_step_matches_the_serial_step():
    """Each rank embeds its four rows; the all-gathered similarity, each
    rank's share of the loss and the summed gradients make the serial
    step: the loss within 1e-6, the params within 1e-6, and bitwise equal
    across the ranks."""
    ranks = [r.value for r in spawn_world(clip_rank, 2, use_cuda=False,
                                          threads=1)]
    for r in ranks:
        (p, loss), (sp, sloss) = r["dp"], r["serial"]
        assert abs(float(loss) - float(sloss)) < 1e-6
        for k in sp:
            np.testing.assert_allclose(p[k].numpy(), sp[k].numpy(),
                                       rtol=1e-5, atol=1e-6)
            assert torch.equal(p[k], ranks[0]["dp"][0][k])


@pytest.mark.parametrize("extra", [
    ["--tpu_seed_sweep", "2", "--tpu_mesh_dp", "2"],
    ["--tpu_mesh_mp", "2"],
    ["--tpu_mesh_dp", "2"],
    ["--tpu_import", "os", "--tpu_mesh_dp", "2"],
], ids=["sweep-dp2", "mp2", "dp2", "import-dp2"])
def test_the_multi_device_modes_run(tmp_path, capsys, monkeypatch, extra):
    """The cases the driver refused until item 9's multi-device part was
    ported (they were cases of ``tests/test_torch_cli.py::
    test_what_is_not_ported_raises_naming_its_item``): in one process the
    driver spawns two CPU ranks, and rank 0 alone writes the run dir and
    the result."""
    from fumi_tpu_torch.cli import main as cli_main
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks inherit it
    out = cli_main.main(config_from_args(
        COMMON + ["--model", "fumi", "--im_emb_dim", "32", "--epochs", "2",
                  "--eval_freq", "2", "--num_ep_test", "8",
                  "--log_dir", str(tmp_path)] + extra))
    assert np.isfinite(out["test/loss"])
    assert "spawning 2 ranks" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "runs")) == 1


@pytest.mark.parametrize("extra", [
    ["--model", "fumi", "--tpu_mesh_mp", "2", "--tpu_grad_accum", "2"],
    ["--model", "fumi", "--tpu_mesh_dp", "2", "--tpu_seed_sweep", "4",
     "--tpu_seed_accum", "2"],
    ["--model", "fumi", "--tpu_seed_sweep", "4", "--tpu_dist_num_processes",
     "2", "--tpu_dist_coordinator", "localhost:1"],
], ids=["grad_accum-with-mp", "seed_accum-with-dp", "multi-host-sweep"])
def test_the_jax_refusals_stand(tmp_path, extra):
    """The JAX package's refusals, before any rank starts."""
    from fumi_tpu_torch.cli import main as cli_main
    with pytest.raises(NotImplementedError):
        cli_main.main(config_from_args(
            COMMON + ["--im_emb_dim", "256", "--log_dir", str(tmp_path)]
            + extra))
