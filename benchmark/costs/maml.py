"""Model operations of MAML's meta-training step on Conv-4-64, from the
products' shapes (``costs/meta.py``'s rule: a support image costs
4·u0 + 9·Σ others an inner step, a query image 2·u0 + 3·Σ others)."""

from benchmark.costs import meta


def conv_units(config):
    """Each convolution's forward operations for one image: 2·(out
    positions)·out·in·k² (SAME padding, so a block's output has its
    input's side, which the pool then halves, an odd row dropped)."""
    w = config["widths"]
    side, cin, k, hidden = (w["im_size"], w["im_channels"], w["kernel"],
                            w["hidden"])
    out = []
    for _ in range(w["blocks"]):
        out.append(2 * side * side * hidden * cin * k * k)
        side, cin = side // 2, hidden
    return out, side * side * hidden


def units(config):
    """Every product of the network for one image: the convolutions,
    then the head."""
    convs, features = conv_units(config)
    return convs + [2 * features * config["widths"]["num_ways"]]


def _step(config, layer_units):
    ep, tr = config["episode"], config["train"]
    s = ep["num_ways"] * ep["num_shots"]
    q = ep["num_ways"] * ep["num_query_train"]
    task = meta.second_order_task([s * u for u in layer_units],
                                  [q * u for u in layer_units],
                                  tr["inner_steps"])
    return tr["batch_size"] * task


def conv_flops_by_layer(config):
    """The convolution products' operations a step, per block: each
    block's share of the rule's count (its own units, layer 0 counted as
    the data's layer, the others as the rest)."""
    convs, _ = conv_units(config)
    out = []
    for i in range(len(convs)):
        alone = [c if j == i else 0 for j, c in enumerate(convs)]
        out.append(_step(config, alone))
    return out


def conv_flops(config) -> float:
    """The convolution products' operations of one step."""
    return float(sum(conv_flops_by_layer(config)))


def step_flops(config) -> float:
    """One meta-training step of B tasks: every product, the head too."""
    return float(_step(config, units(config)))
