"""Device-idle ms a traced fit inside the column-block factor: the idle
gaps of the traced sub-window whose midpoints fall inside one of the
program's `exact.block` spans (each block's Gram panel, updates, factor
and row solves: `ops/linalg.py::fused_panel_cholesky`), summed and
divided by the traced fits. The host's part of each block, mostly the
panel factor's info read and the launches after it. None where the
program records no such span."""


def read(ctx):
    fits = ctx.counts.get("traced_fits", 0)
    if ctx.traced is None or not fits or ctx.spans is None:
        return None
    blocks = [(a, b) for name, a, b, _ in ctx.spans.items
              if name == "exact.block"]
    if not blocks:
        return None
    idle = sum(e - s for s, e in ctx.traced.gaps()
               if any(a <= 0.5 * (s + e) <= b for a, b in blocks))
    return 1e3 * idle / fits
