"""Reference ``.pth.tar`` files in the port against the JAX package's
importer and exporter, on the CPU.

- A JAX state exported by ``fumi_tpu.interop.export_torch_checkpoint``
  and imported by the port: params bitwise the bridged JAX params, Adam's
  moments and count (SGD's trace) bitwise the optax state's, any EMA reset
  to the imported params, the served logits the JAX classifier's within
  1e-4 (fp32 both sides, other summation orders).
- The port's export read by ``fumi_tpu.interop.load_torch_checkpoint``:
  params and moments bitwise.
- A bare state_dict, a corrupt file (``ValueError``), a shape mismatch
  (``ValueError`` naming the saved widths), a wrong family, extensions
  with no reference format.
- ``python -m fumi_tpu_torch.cli.export_torch`` on a run dir of the
  port's driver, and the file back through ``--evaluate --checkpoint``
  (the run dir's own test numbers) and ``load_checkpoint``.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fumi_tpu import interop as jax_interop
from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.serve import FewShotClassifier as JaxClassifier
from fumi_tpu.train import steps as jax_steps
from fumi_tpu_torch import bridge, interop
from fumi_tpu_torch.cli import export_torch
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core.config import Config, config_from_args
from fumi_tpu_torch.serve import FewShotClassifier
from fumi_tpu_torch.train import checkpoint, optim, steps
from fumi_tpu_torch.train.clip_loop import make_clip

N, K, Q, D, E = 3, 2, 5, 16, 8
CASES = {
    "maml": dict(optim="SGD", lr=0.1),
    "fumi": dict(optim="adam", ema=0.9, skip_nonfinite=2),
    "am3": dict(optim="adamw_lin_schedule", text_encoder="rand"),
    "clip": dict(optim="adam"),
}


def kw_of(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(8, 4), text_hid_dim=8, prototype_dim=8,
             clip_latent_dim=8, num_ways=N, num_shots=K, num_shots_test=3,
             batch_size=2, num_test_adapt_steps=5, step_size=0.1,
             dropout=0.0, text_encoder="precomputed", seed=0)
    d.update(CASES.get(model, {}))
    d.update(kw)
    return d


def jax_state(model, **kw):
    """JAX params and an optimizer state two updates on (random grads)."""
    jcfg = JaxConfig(**kw_of(model, **kw))
    if model == "clip":
        from fumi_tpu.train.clip_loop import make_clip as jax_make_clip
        _, params = jax_make_clip(jcfg, jax.random.PRNGKey(0))
    else:
        params = jax_steps.build_family(jcfg, jax.random.PRNGKey(0)).params
    opt = jax_steps.make_opt(jcfg)
    state = opt.init(params)
    rng = np.random.RandomState(1)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)),
            params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return jcfg, params, state


def port_template(model, cfg):
    gen = torch.Generator().manual_seed(0)
    if model == "clip":
        return make_clip(cfg, gen)[1]
    return steps.build_family(cfg, gen).params


def adam_or_sgd(state):
    """The (mu, nu, count) or (trace,) of the optax state."""
    found = []

    def walk(s):
        if isinstance(s, optax.ScaleByAdamState):
            found.append((s.mu, s.nu, int(s.count)))
        elif isinstance(s, optax.TraceState):
            found.append((s.trace,))
        elif isinstance(s, (tuple, list)):
            for c in s:
                walk(c)
    walk(state)
    return found[0]


def port_adam_or_sgd(state):
    """The (mu, nu, count) or (trace,) of the port's state."""
    stack = [state]
    while stack:
        s = stack.pop()
        if set(s) == {"count", "mu", "nu"}:
            return s["mu"], s["nu"], int(s["count"])
        if set(s) == {"trace"}:
            return (s["trace"],)
        stack += [v for v in s.values() if isinstance(v, dict)]
    raise AssertionError("no Adam or SGD state")


def to_np(model, tree):
    if model == "clip":
        return {k: {"w": tree[k + ".weight"].numpy(),
                    "b": tree[k + ".bias"].numpy()}
                for k in interop.CLIP_LAYERS}
    return bridge.params_to_numpy(tree, model)


def same_tree(got, want):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("model", list(CASES))
def test_a_jax_export_imports_into_the_port(tmp_path, model):
    jcfg, jparams, jstate = jax_state(model)
    path = str(tmp_path / "jax.pth.tar")
    jax_interop.export_torch_checkpoint(
        path, jparams, model, opt_state=jstate, args={"model": model},
        batch_idx=7, best_loss=0.5, optim=jcfg.optim)
    cfg = Config(**kw_of(model))
    like = port_template(model, cfg)
    opt = steps.make_opt(cfg)
    params, state, meta = interop.load_torch_checkpoint(path, like,
                                                        opt.init(like))
    assert meta["batch_idx"] == 7 and meta["best_loss"] == 0.5
    assert list(params) == list(like)
    same_tree(to_np(model, params), jparams)
    want, got = adam_or_sgd(jstate), port_adam_or_sgd(state)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if isinstance(w, int):
            assert g == w
        else:
            same_tree(to_np(model, g), w)
    if cfg.ema > 0:
        for k, v in optim.find_ema(state).items():
            assert v is params[k]  # the EMA points at the import
    # the same file through load_checkpoint, where serving finds it
    p2, _, _ = checkpoint.load_checkpoint(path, like, opt.init(like))
    for k in p2:
        assert torch.equal(p2[k], params[k])


@pytest.mark.parametrize("model", ["maml", "fumi", "am3"])
def test_served_logits_of_an_imported_file_equal_the_jax_servers(tmp_path,
                                                                 model):
    # AM3 with BERT-style (identity) text: the rand encoder's noise is
    # each package's own
    kw = dict(text_encoder="precomputed") if model == "am3" else {}
    jcfg, jparams, jstate = jax_state(model, **kw)
    path = str(tmp_path / "jax.pth.tar")
    jax_interop.export_torch_checkpoint(path, jparams, model,
                                        opt_state=jstate,
                                        optim=jcfg.optim)
    cfg = Config(**kw_of(model, **kw))
    clf = FewShotClassifier.from_checkpoint(path, cfg, device="cpu")
    jc = JaxClassifier(jcfg, jparams)
    rng = np.random.RandomState(0)
    s_im = rng.randn(N * K, D).astype(np.float32)
    s_tx = rng.randn(N * K, E).astype(np.float32)
    s_y = np.repeat(np.arange(N), K).astype(np.int32)
    q_im = rng.randn(Q, D).astype(np.float32)
    text = None if model == "maml" else s_tx
    got = clf.episode_logits(s_im, s_y, q_im, support_text=text)
    want = np.asarray(jc.episode_logits(s_im, s_y, q_im, support_text=text))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("model", list(CASES))
def test_the_ports_export_imports_into_the_jax_package(tmp_path, model):
    """The port's params and optimizer state after two updates, exported
    by the port, read back by the JAX package's importer."""
    cfg = Config(**kw_of(model))
    params = port_template(model, cfg)
    opt = steps.make_opt(cfg)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(2)
    for _ in range(2):
        grads = {k: torch.randn(v.shape, generator=gen)
                 for k, v in params.items()}
        u, state = opt.update(grads, state, params)
        params = optim.apply_updates(params, u)
    path = str(tmp_path / "port.pth.tar")
    interop.export_torch_checkpoint(path, params, model, opt_state=state,
                                    args={"model": model}, batch_idx=3,
                                    optim=cfg.optim)
    jcfg, jlike, _ = jax_state(model)
    jopt = jax_steps.make_opt(jcfg)
    jp, js, meta = jax_interop.load_torch_checkpoint(path, jlike,
                                                     jopt.init(jlike))
    assert meta["batch_idx"] == 3
    same_tree(jp, to_np(model, params))
    want, got = port_adam_or_sgd(state), adam_or_sgd(js)
    for w, g in zip(want, got):
        if isinstance(w, int):
            assert g == w
        else:
            same_tree(g, to_np(model, w))
    ckpt = torch.load(path, weights_only=False)
    group = ckpt["optimizer"]["param_groups"][0]
    # the same param group and state_dict order as the JAX exporter's
    jax_interop.export_torch_checkpoint(str(tmp_path / "jax.pth.tar"), jp,
                                        model, opt_state=js,
                                        optim=cfg.optim)
    theirs = torch.load(str(tmp_path / "jax.pth.tar"), weights_only=False)
    assert group == theirs["optimizer"]["param_groups"][0]
    assert list(ckpt["state_dict"]) == list(theirs["state_dict"])


def test_a_bare_state_dict_and_the_family_from_the_keys(tmp_path):
    cfg = Config(**kw_of("fumi"))
    like = port_template("fumi", cfg)
    sd = {k: v + 1.0 for k, v in like.items()}
    path = str(tmp_path / "bare.pth")
    torch.save(sd, path)
    params, state, meta = interop.load_torch_checkpoint(path, like)
    assert meta == {} and state is None
    for k in like:
        assert torch.equal(params[k], sd[k])
    assert interop.detect_family(sd) == "fumi"
    with pytest.raises(ValueError, match="cannot infer a model family"):
        interop.detect_family({"foo.weight": 1})


def test_a_corrupt_file_is_a_value_error(tmp_path):
    path = tmp_path / "best.pth.tar"
    path.write_bytes(b"not a pickle")
    with pytest.raises(ValueError, match="not a loadable torch checkpoint"):
        interop.load_torch_checkpoint(str(path))
    with pytest.raises(ValueError, match="not a loadable torch checkpoint"):
        checkpoint.load_checkpoint(str(path), {}, {})


def test_a_shape_mismatch_names_the_saved_widths(tmp_path):
    jcfg, jparams, jstate = jax_state("fumi")
    path = str(tmp_path / "f.pth.tar")
    jax_interop.export_torch_checkpoint(
        path, jparams, "fumi", opt_state=jstate,
        args={"model": "fumi", "im_hid_dim": [8, 4]})
    wide = Config(**kw_of("fumi", im_hid_dim=(12, 4)))
    like = port_template("fumi", wide)
    with pytest.raises(ValueError, match=r"does not fit.*trained with "
                                         r"\{'model': 'fumi', 'im_hid_dim'"):
        interop.load_torch_checkpoint(path, like)
    deep = port_template("fumi", Config(**kw_of("fumi",
                                                im_hid_dim=(8, 4, 4))))
    with pytest.raises(ValueError, match="structure mismatch"):
        interop.load_torch_checkpoint(path, deep)
    with pytest.raises(ValueError, match="missing key .* wrong --model"):
        interop.load_torch_checkpoint(path, family="am3")


def test_extensions_have_no_reference_format(tmp_path):
    raw = Config(**kw_of("maml", im_encoder="conv4", im_size=16))
    params = port_template("maml", raw)
    with pytest.raises(ValueError, match="no reference checkpoint format"):
        interop.export_torch_checkpoint(str(tmp_path / "x"), params, "maml")
    with pytest.raises(ValueError, match="no torch interop"):
        interop.reference_names("protonet", params)


def test_frozen_params_without_torch_state_keep_zero_moments(tmp_path):
    cfg = Config(**kw_of("fumi", optim="adam", ema=0.0, skip_nonfinite=0))
    like = port_template("fumi", cfg)
    order = interop.reference_names("fumi", like)
    state = {i: {"step": torch.tensor(4.0),
                 "exp_avg": torch.ones(like[n].shape),
                 "exp_avg_sq": torch.full(like[n].shape, 2.0)}
             for i, n in enumerate(order) if not n.startswith("im_net.")}
    path = str(tmp_path / "f.pth.tar")
    torch.save({"batch_idx": 1, "state_dict": interop.params_to_torch(
        like, "fumi"), "best_loss": 1.0, "optimizer": {
        "state": state, "param_groups": []}, "args": {}}, path)
    _, s, _ = interop.load_torch_checkpoint(path, like,
                                            steps.make_opt(cfg).init(like))
    assert s["count"] == 4
    for k, v in s["mu"].items():
        assert torch.equal(v, torch.zeros_like(v) if k.startswith("im_net.")
                           else torch.ones_like(v))


def test_export_cli_round_trip_through_the_driver(tmp_path):
    argv = ["--model", "fumi", "--dataset", "synthetic", "--im_emb_dim",
            str(D), "--text_emb_dim", str(E), "--im_hid_dim", "8", "4",
            "--text_hid_dim", "8", "--num_ways", str(N), "--num_shots",
            str(K), "--num_shots_test", "3", "--batch_size", "2",
            "--num_ep_test", "4", "--epochs", "4", "--eval_freq", "2",
            "--num_train_adapt_steps", "2", "--num_test_adapt_steps", "5",
            "--lr", "0.05", "--step_size", "0.1", "--dropout", "0",
            "--text_encoder", "precomputed", "--seed", "0",
            "--wandb_offline", "--disable_cuda", "--tpu_ema", "0.5"]
    cli_main.cli(argv + ["--log_dir", str(tmp_path / "train")])
    (run,) = glob.glob(str(tmp_path / "train" / "runs" / "*"))
    out = str(tmp_path / "run.pth.tar")
    assert export_torch.main([run, out]) == out
    from_dir = cli_main.cli(argv + ["--log_dir", str(tmp_path / "a"),
                                    "--evaluate", "--checkpoint", run])
    from_file = cli_main.cli(argv + ["--log_dir", str(tmp_path / "b"),
                                     "--evaluate", "--checkpoint", out])
    assert from_file == from_dir
    cfg = config_from_args(argv)
    clf = FewShotClassifier.from_checkpoint(out, cfg, device="cpu")
    ref = FewShotClassifier.from_checkpoint(run, cfg, device="cpu")
    for k in ref.params:  # the EMA was exported, and it is what serves
        assert torch.equal(clf.params[k], ref.params[k])
    with pytest.raises(SystemExit, match="no config.json"):
        export_torch.main([str(tmp_path), out])
    assert os.path.getsize(out) > 0
