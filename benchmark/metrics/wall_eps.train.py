"""Meta-training episodes completed over the whole window on the host's
clock, up to its last synchronisation (a ``--trace 1`` run, whose window
runs unprofiled): the rate a researcher waits on, which the host's speed
sets in a host-bound step."""


def read(ctx, rec):
    if not rec.get("window_s") or not ctx.trace:
        return None
    return rec["episodes"] / rec["window_s"]
