"""The device's time of a meta-training episode: the union of the device
operations' intervals over every chunk of the window (each profiled, the
device's activity alone), over every episode of the window. The card's
own clock, which the host's stalls do not move."""


def read(ctx, rec):
    if not rec.get("device_s"):
        return None
    return 1000.0 * rec["device_s"] / rec["episodes"]
