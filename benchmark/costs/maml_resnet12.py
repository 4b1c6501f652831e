"""Model operations of MAML's meta-training step on ResNet-12, from the
products' shapes (``costs/meta.py``'s rule). Two layers read the data:
stage 0's first 3×3 convolution and its 1×1 shortcut both take the images,
which need no gradient; every other product is counted as the rest."""

from benchmark.costs import meta


def conv_layers(config):
    """Each convolution of the network, in order: ``(stage, unit, side,
    C_in, C_out, k, ops)``, ``ops`` its forward operations for one image,
    2·side²·C_out·C_in·k² (SAME padding: a stage's units keep its input's
    side, which the pool then halves, an odd row dropped)."""
    w = config["widths"]
    side, cin = w["im_size"], w["im_channels"]
    k, k_sc = w["kernel"], w["shortcut_kernel"]
    out = []
    for i, ch in enumerate(w["channels"]):
        for unit, c, kk in (("c1", cin, k), ("c2", ch, k), ("c3", ch, k),
                            ("sc", cin, k_sc)):
            out.append((i, unit, side, c, ch, kk,
                        2 * side * side * ch * c * kk * kk))
        side, cin = side // 2, ch
    return out


def _reads_data(layer) -> bool:
    return layer[0] == 0 and layer[1] in ("c1", "sc")


def _step(config, layers, head: bool) -> float:
    """The rule's count over ``layers`` (and the head where ``head``): the
    data's layers summed as its layer 0, the rest after it."""
    data = sum(l[6] for l in layers if _reads_data(l))
    rest = [l[6] for l in layers if not _reads_data(l)]
    w = config["widths"]
    if head:
        rest.append(2 * w["channels"][-1] * w["num_ways"])
    ep, tr = config["episode"], config["train"]
    s = ep["num_ways"] * ep["num_shots"]
    q = ep["num_ways"] * ep["num_query_train"]
    units = [data] + rest
    task = meta.second_order_task([s * u for u in units],
                                  [q * u for u in units], tr["inner_steps"])
    return float(tr["batch_size"] * task)


def conv_flops(config) -> float:
    """The 3×3 convolutions' products of one step: what the convolution
    kernels (``benchmark/convs.py``) compute; the 1×1 shortcut, a GEMM
    there, is left out."""
    return _step(config, [l for l in conv_layers(config) if l[5] == 3],
                 head=False)


def step_flops(config) -> float:
    """One meta-training step of B tasks: every product, the shortcut and
    the head too."""
    return _step(config, conv_layers(config), head=True)
