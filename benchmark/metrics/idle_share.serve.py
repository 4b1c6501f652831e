"""The share of the profiled stretch in which no device operation ran:
1 - the union of the device's intervals over the stretch."""


def read(ctx, rec):
    tr = rec.get("trace")
    share = tr.idle_share() if tr is not None else None
    return None if share is None else 100.0 * share
