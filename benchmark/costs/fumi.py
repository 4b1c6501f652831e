"""Model operations of FuMI's served request and meta-training step."""

from benchmark.costs import kernels, meta


def _dims(config):
    w = config["widths"]
    h1, h2 = w["im_hid_dim"]
    return (w["im_emb_dim"], h1, h2, w["text_emb_dim"], w["text_hid_dim"],
            w["num_ways"])


def hyper_units(config):
    """The hypernetwork's two products over a task's N class texts."""
    d, h1, h2, e, t, n = _dims(config)
    return [2 * n * e * t, 2 * n * t * (h2 + 1)]


def mlp_units(config, rows):
    d, h1, h2, e, t, n = _dims(config)
    return [2 * rows * d * h1, 2 * rows * h1 * h2, 2 * rows * h2 * n]


def request_flops(config, m: int) -> float:
    """One episode of ``m`` queries: the hypernetwork, the test-time
    adaptation and the query forward (``kernels.fused_adapt_cost``)."""
    d, h1, h2, e, t, n = _dims(config)
    s = config["episode"]["num_ways"] * config["episode"]["num_shots"]
    adapt, _ = kernels.fused_adapt_cost(
        1, s, m, d, h1, h2, n, config["serve"]["test_adapt_steps"])
    return meta.forward(hyper_units(config)) + adapt


def step_flops(config) -> float:
    """One meta-training step of B tasks."""
    ep, tr = config["episode"], config["train"]
    s = ep["num_ways"] * ep["num_shots"]
    q = ep["num_ways"] * ep["num_query_train"]
    hyper = hyper_units(config)
    task = (meta.forward(hyper) + meta.backward(hyper)
            + meta.second_order_task(mlp_units(config, s),
                                     mlp_units(config, q),
                                     tr["inner_steps"]))
    return tr["batch_size"] * task
