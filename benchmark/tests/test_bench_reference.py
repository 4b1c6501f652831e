"""Each plain reference against the program at tiny sizes on the CPU, and
the references' independence from the program."""

import ast
import os

import numpy as np
import pytest
import torch

from conftest import FUMI, REPO
from benchmark.reference import common, fumi


def port_config(cfg):
    from fumi_tpu_torch.core.config import Config
    port = dict(cfg["port"])
    if "im_hid_dim" in port:
        port["im_hid_dim"] = tuple(port["im_hid_dim"])
    return Config(**port)


@pytest.mark.parametrize("cfg,ref", [(FUMI, fumi)], ids=["fumi"])
def test_reference_leaves_are_the_programs(cfg, ref):
    from fumi_tpu_torch.train.steps import build_family
    family = build_family(port_config(cfg), torch.Generator().manual_seed(0))
    ours = common.init_params(ref.specs(cfg), 3, "cpu")
    assert {k: tuple(v.shape) for k, v in family.params.items()} == \
        {k: tuple(v.shape) for k, v in ours.items()}


def test_weights_follow_the_seed_and_torch_linear_bounds():
    a = common.init_params(fumi.specs(FUMI), 11, "cpu")
    b = common.init_params(fumi.specs(FUMI), 11, "cpu")
    c = common.init_params(fumi.specs(FUMI), 12, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["im_net.linear0.weight"],
                           c["im_net.linear0.weight"])
    bound = 1 / np.sqrt(FUMI["widths"]["im_emb_dim"])
    assert float(a["im_net.linear0.weight"].abs().max()) <= bound
    const = common.init_params([("g", (4,), "ones"), ("b", (4,), "zeros"),
                                ("w", (2, 3), 0.5)], 2, "cpu")
    assert torch.equal(const["g"], torch.ones(4))
    assert torch.equal(const["b"], torch.zeros(4))
    assert float(const["w"].abs().max()) <= 0.5


def test_fumi_serving_reference_matches_the_classifier():
    from fumi_tpu_torch.serve import FewShotClassifier
    p = common.init_params(fumi.specs(FUMI), 4, "cpu")
    clf = FewShotClassifier(port_config(FUMI), params=p, device="cpu")
    rng = np.random.default_rng(0)
    N, K, D, E = 3, 2, 24, 10
    s_im = rng.random((N * K, D), dtype=np.float32)
    q_im = rng.random((7, D), dtype=np.float32)
    s_y = np.repeat(np.arange(N), K).astype(np.int32)
    text = rng.standard_normal((N, E)).astype(np.float32)
    got = clf.episode_logits(s_im, s_y, q_im,
                             support_text=np.repeat(text, K, axis=0))
    want = fumi.serve_logits(p, torch.from_numpy(s_im)[None],
                             torch.from_numpy(s_y)[None],
                             torch.from_numpy(q_im)[None],
                             torch.from_numpy(text)[None], 5, 0.1)[0]
    assert np.allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


def test_dropout_noise_is_taken_by_shape_in_order():
    d = [torch.rand(2, 3), torch.rand(4, 5, 6), torch.rand(4, 5, 6)]
    n = common.Noise(d)
    assert n.take((4, 5, 6)) is d[1] and n.take((4, 5, 6)) is d[2]
    with pytest.raises(LookupError):
        n.take((2, 3))
    x = torch.ones(4, 5, 6)
    out = common.dropout(x, 0.25, common.Noise([d[1]]))
    assert torch.equal(out, torch.where(d[1] < 0.75, x / 0.75,
                                        torch.zeros_like(x)))


def test_adam_reference_is_torch_adam_with_coupled_decay():
    class One:
        @staticmethod
        def loss_and_grads(p, episode, noise, train):
            return torch.tensor(1.0), {"w": torch.full((3,), 0.5)}
    train = {"lr": 0.1, "weight_decay": 0.01, "adam_betas": [0.9, 0.999],
             "adam_eps": 1e-8}
    out = common.follow(One, {"w": torch.ones(3)}, [{}], [None], train)
    assert torch.allclose(out["grad1"]["w"], torch.full((3,), 0.51))
    assert torch.allclose(out["delta"]["w"], torch.full((3,), -0.1))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def yardstick_files():
    """The reference, the costs and the reductions: nothing of the
    program in them."""
    out = []
    for sub in ("reference", "costs", "metrics"):
        d = os.path.join(REPO, "benchmark", sub)
        out += [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith(".py")]
    out += [os.path.join(REPO, "benchmark", f) for f in
            ("stats.py", "check.py", "trace.py", "data.py", "traffic.py")]
    return out


@pytest.mark.parametrize("path", yardstick_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_yardstick_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"fumi_tpu_torch", "fumi_tpu", "jax", "jaxlib",
                       "flax"}, tops
