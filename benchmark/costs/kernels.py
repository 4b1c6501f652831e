"""Operations and bytes of the port's kernels, from shapes alone, so a
roofline reads the same work whatever implements it."""


def fused_adapt_cost(b, s, qn, d, h1, h2, n, steps):
    """(flops, bytes) the fused adaptation must do and move: per task-step
    2·S·(2·D·H1 + 3·H1·H2 + 3·H2·N) (forward, and backward to every
    weight), the query forward 2·Qn·(D·H1 + H1·H2 + H2·N); each input read
    once and the logits written once."""
    flops = (b * steps * 2 * s * (2 * d * h1 + 3 * h1 * h2 + 3 * h2 * n)
             + b * 2 * qn * (d * h1 + h1 * h2 + h2 * n))
    floats = (b * s * d + b * s + b * qn * d + h1 * d + h1 + h2 * h1 + h2
              + b * n * h2 + b * n + b * qn * n)
    return flops, 4 * floats


def gather_bytes(m: int, row_bytes: int) -> int:
    """Bytes a row gather must move: M rows read, M rows written, M int32
    indices read; it does no arithmetic."""
    return 2 * m * row_bytes + 4 * m


def widen_bytes(m: int, d: int, elem: int) -> int:
    """Bytes a widening row gather must move: M rows of ``elem``-byte
    elements read, M fp32 rows written, M int32 indices read."""
    return m * d * (elem + 4) + 4 * m
