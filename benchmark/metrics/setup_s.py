"""Set-up time: process start to the first timed unit (import, tables and
weights made on the device, the program built, the kernels loaded or
built, the warm-up of the cell's own shapes)."""


def read(ctx, rec):
    return rec.get("setup_s")
